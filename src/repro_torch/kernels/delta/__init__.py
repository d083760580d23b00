from repro_torch.kernels.delta.ops import xor_delta, xor_delta_plain
from repro_torch.kernels.delta.ref import delta_ref

__all__ = ["delta_ref", "xor_delta", "xor_delta_plain"]
