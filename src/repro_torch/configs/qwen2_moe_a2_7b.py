"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936, qkv_bias=True,
        moe=MoEConfig(
            n_experts=60, top_k=4, n_shared=4,
            expert_d_ff=1408, shared_d_ff=5632,
        ),
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=48, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, expert_d_ff=48,
                      shared_d_ff=96),
        param_dtype="float32", compute_dtype="float32",
    )
