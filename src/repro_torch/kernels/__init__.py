"""Hand-written CUDA kernels (sm_90a) for the checkpoint path.

Counterparts of the Pallas TPU kernels in ``repro.kernels`` that the
port's main path runs: the fused XOR-delta / dirty-count / digest pass
and the int8 block quantizer. Each wrapper launches its kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor; sources
are under ``*/csrc/`` and are built by :mod:`repro_torch.kernels.build`
on first use.
"""
from repro_torch.kernels.fused import (
    digests_from_meta,
    fused_precodec,
)
from repro_torch.kernels.quantize import quantize

__all__ = [
    "digests_from_meta",
    "fused_precodec",
    "quantize",
]
