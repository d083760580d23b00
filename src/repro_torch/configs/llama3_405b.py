"""llama3-405b [dense] — GQA 128/8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab_size=128256,
        rope_theta=5e5, param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=320, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
