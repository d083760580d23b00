from repro_torch.kernels.fused.ops import (
    CHUNK_ALIGN,
    TILE,
    digests_from_meta,
    dirty_from_meta,
    fused_precodec,
    fused_precodec_plain,
)
from repro_torch.kernels.fused.ref import chunk_digests_ref, fused_ref

__all__ = [
    "CHUNK_ALIGN",
    "TILE",
    "chunk_digests_ref",
    "digests_from_meta",
    "dirty_from_meta",
    "fused_precodec",
    "fused_precodec_plain",
    "fused_ref",
]
