from repro_torch.kernels.quantize.ops import (
    dequantize,
    dequantize_plain,
    quantize,
    quantize_blocks_needed,
    quantize_plain,
)
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref

__all__ = [
    "dequantize",
    "dequantize_plain",
    "dequantize_ref",
    "quantize",
    "quantize_blocks_needed",
    "quantize_plain",
    "quantize_ref",
]
