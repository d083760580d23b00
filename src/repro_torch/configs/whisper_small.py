"""whisper-small [audio] — enc-dec; conv/mel frontend is a STUB
(input_specs feeds precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        encdec=True, n_enc_layers=12, enc_seq=1500, tie_embeddings=True,
        param_dtype="float32", compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, n_enc_layers=2, enc_seq=12,
        param_dtype="float32", compute_dtype="float32",
    )
