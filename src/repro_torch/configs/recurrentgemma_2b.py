"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn"),
        window=2048, tie_embeddings=True,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=192, vocab_size=256, window=8,
        param_dtype="float32", compute_dtype="float32",
    )
