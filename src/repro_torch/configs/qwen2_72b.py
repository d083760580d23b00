"""qwen2-72b [dense] — GQA 64/8, QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064, qkv_bias=True,
        rope_theta=1e6, param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
