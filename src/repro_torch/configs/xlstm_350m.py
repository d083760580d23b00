"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),  # 3:1 m:s ratio
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
    )
