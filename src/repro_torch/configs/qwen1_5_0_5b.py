"""qwen1.5-0.5b [dense] — MHA 16/16, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab_size=151936, qkv_bias=True,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=192, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
