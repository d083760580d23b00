from repro_torch.data.pipeline import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens"]
