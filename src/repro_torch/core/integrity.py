"""Checkpoint integrity: fast host-side checksums.

Host path uses zlib.crc32 (C speed).  The device path — checksumming
checkpoint shards *before* D2H so corruption in the flush pipeline is
detectable — is the CUDA kernel in :mod:`repro_torch.kernels.checksum`
(``digest_array`` of a tensor on the card, whole-stream ``checksum_u32``),
and per-chunk digests come from the fused pre-codec pass
(:mod:`repro_torch.kernels.fused`). Both match the oracle
``repro_torch.kernels.checksum.ref.digest_ref``, not
:func:`fletcher64_np` below, which works mod 2**32 - 1.
"""
from __future__ import annotations

import zlib

import numpy as np

_MOD = (1 << 32) - 1


def crc32(data) -> int:
    """CRC-32 of any C-contiguous buffer — bytes, bytearray, memoryview,
    ndarray — hashed in place via the buffer protocol.

    The zero-copy encode path hands out memoryview slices of one shared
    stream buffer; hashing them must not materialize a ``bytes`` copy of
    every rank blob.  Non-contiguous objects (strided array views) fall
    back to a compacting copy, which is the only case that needs one.
    """
    try:
        return zlib.crc32(data) & 0xFFFFFFFF
    except (TypeError, BufferError, ValueError):
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data)
            return zlib.crc32(data.view(np.uint8)) & 0xFFFFFFFF
        return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def fletcher64_np(words: np.ndarray) -> int:
    """Fletcher-64 over uint32 words, vectorized (a host checksum; the
    device kernels' digest is ``checksum.ref.digest_ref``).

    sum1 = (Σ w_i) mod (2^32 - 1);  sum2 = (Σ partial sums) mod (2^32 - 1)
    Equivalently sum2 = Σ (n - i) * w_i.
    """
    w = np.ascontiguousarray(words, dtype=np.uint32).astype(np.uint64)
    n = w.size
    if n == 0:
        return 0
    sum1 = int(w.sum() % _MOD)
    weights = np.arange(n, 0, -1, dtype=np.uint64)
    # chunk to avoid overflow: max term < 2^32 * n, accumulate in python int
    sum2 = 0
    CH = 1 << 16
    for i in range(0, n, CH):
        sum2 += int((w[i : i + CH] * weights[i : i + CH] % _MOD).sum())
    sum2 %= _MOD
    return (sum2 << 32) | sum1


def fletcher64_bytes(data: bytes) -> int:
    buf = np.frombuffer(data, dtype=np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return fletcher64_np(buf.view(np.uint32))
