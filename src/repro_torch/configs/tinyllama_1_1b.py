"""tinyllama-1.1b [dense] — llama2-arch small, GQA 32/4 [arXiv:2401.02385]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab_size=32000,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
