"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + 1 shared, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        moe=MoEConfig(
            n_experts=16, top_k=1, n_shared=1,
            expert_d_ff=8192, shared_d_ff=8192,
        ),
        # 40 heads don't shard over 16-way TP -> scores replicate on the
        # head dim; a small q-chunk bounds the live score tensor.
        chunk_q=128,
        rope_theta=5e5, param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=1, n_shared=1, expert_d_ff=96,
                      shared_d_ff=96),
        param_dtype="float32", compute_dtype="float32",
    )
