from repro_torch.kernels.quantize.ops import quantize, quantize_blocks_needed, quantize_plain

__all__ = ["quantize", "quantize_blocks_needed", "quantize_plain"]
