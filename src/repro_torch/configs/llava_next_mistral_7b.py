"""llava-next-mistral-7b [vlm] — mistral backbone; anyres patch frontend is a
STUB (input_specs feeds precomputed patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        n_patches=576,  # one 24x24 anyres tile worth of patch embeddings
        rope_theta=1e6, param_dtype="bfloat16", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=256, n_patches=8,
        param_dtype="float32", compute_dtype="float32",
    )
