from repro_torch.models.api import Model, get_model
from repro_torch.models.config import ModelConfig, MoEConfig

__all__ = ["Model", "get_model", "ModelConfig", "MoEConfig"]
