from repro_torch.kernels.checksum.ops import (
    checksum_pair,
    checksum_u32,
    checksum_u32_plain,
    digest_array,
    digest_bytes,
    digest_of,
)
from repro_torch.kernels.checksum.ref import checksum_ref_np, digest_ref

__all__ = [
    "checksum_pair",
    "checksum_u32",
    "checksum_u32_plain",
    "checksum_ref_np",
    "digest_array",
    "digest_bytes",
    "digest_of",
    "digest_ref",
]
