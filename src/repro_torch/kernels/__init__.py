"""Hand-written CUDA kernels (sm_90a) for the checkpoint path.

Counterparts of the five Pallas TPU kernels in ``repro.kernels``, with
the same public names: the whole-stream two-track checksum
(``checksum_u32``, ``digest_bytes``, ``digest_array``), the XOR delta
(``xor_delta``), the fused XOR-delta / dirty-count / digest pass
(``fused_precodec``) and the int8 block quantizer and dequantizer
(``quantize``, ``dequantize``). Each wrapper launches its kernel on a
CUDA tensor and runs its plain PyTorch version (exported here as
``*_plain``) on a CPU tensor; sources are under ``*/csrc/`` and are
built by :mod:`repro_torch.kernels.build` on first use.
"""
from repro_torch.kernels.checksum import (
    checksum_u32,
    checksum_u32_plain,
    digest_array,
    digest_bytes,
)
from repro_torch.kernels.delta import xor_delta, xor_delta_plain
from repro_torch.kernels.fused import (
    digests_from_meta,
    dirty_from_meta,
    fused_precodec,
    fused_precodec_plain,
)
from repro_torch.kernels.quantize import (
    dequantize,
    dequantize_plain,
    quantize,
    quantize_plain,
)

__all__ = [
    "checksum_u32",
    "checksum_u32_plain",
    "digest_array",
    "digest_bytes",
    "digests_from_meta",
    "dirty_from_meta",
    "fused_precodec",
    "fused_precodec_plain",
    "xor_delta",
    "xor_delta_plain",
    "quantize",
    "quantize_plain",
    "dequantize",
    "dequantize_plain",
]
