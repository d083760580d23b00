"""The fused chunk pre-codec pass: XOR delta, dirty count and digest.

Counterpart of ``repro/kernels/fused/{fused,ops}.py``. ``fused_precodec``
takes the current and base snapshots as flat word streams (the
serialized tree's bytes viewed as ``int32``; the kernel treats the words
as ``uint32``) and makes one pass over the whole state, emitting
per-chunk XOR deltas plus a ``(changed, S, T)`` meta row per chunk.
``CheckpointConfig.chunk_size`` must be a multiple of ``CHUNK_ALIGN``
(4096 bytes, 1024 words) so chunks tile exactly.

On a CUDA tensor the wrapper launches ``csrc/fused_precodec.cu``; on a
CPU tensor it runs :func:`fused_precodec_plain`, the same function in
plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checksum.ref import IDX_MOD
from repro_torch.kernels.common import (
    check_operand,
    count_launch,
    int32_bits,
    on_cpu,
    u32_numpy,
)

TILE = 8 * 128            # words per (8, 128) tile of the reference kernel
CHUNK_ALIGN = TILE * 4    # bytes per tile; chunk_size must be a multiple

_MASK32 = 0xFFFFFFFF
# words per group of chunks in the plain version (bounds its int64 temporaries)
_PLAIN_GROUP_WORDS = 1 << 26


def _check_args(cur: torch.Tensor, base: torch.Tensor, chunk_words: int) -> None:
    if chunk_words <= 0 or chunk_words % TILE:
        raise ValueError(
            f"chunk_words must be a positive multiple of {TILE}, got {chunk_words}"
        )
    if cur.dim() != 1 or cur.shape != base.shape:
        raise ValueError(
            f"need two equal-length 1-D streams, got {tuple(cur.shape)} "
            f"and {tuple(base.shape)}"
        )


def fused_precodec_plain(
    cur: torch.Tensor, base: torch.Tensor, *, chunk_words: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device.

    uint32 arithmetic is done in int64 and masked to 32 bits: each
    product ``(i mod 2**20) * w`` is below 2**52 and is masked before
    the sum, so no int64 sum overflows. Works through groups of chunks
    so its temporaries stay small.
    """
    _check_args(cur, base, chunk_words)
    n = cur.numel()
    n_chunks = -(-n // chunk_words)
    dev = cur.device
    delta = torch.empty((n_chunks, chunk_words), dtype=torch.int32, device=dev)
    meta = torch.empty((n_chunks, 3), dtype=torch.int32, device=dev)
    idx = torch.arange(chunk_words, dtype=torch.int64, device=dev) & (IDX_MOD - 1)
    group = max(1, _PLAIN_GROUP_WORDS // chunk_words)
    for a in range(0, n_chunks, group):
        b = min(n_chunks, a + group)
        lo, hi = a * chunk_words, min(b * chunk_words, n)
        c = torch.zeros((b - a) * chunk_words, dtype=torch.int32, device=dev)
        bb = torch.zeros_like(c)
        c[: hi - lo] = cur[lo:hi]
        bb[: hi - lo] = base[lo:hi]
        c = c.view(b - a, chunk_words)
        d = c ^ bb.view(b - a, chunk_words)
        delta[a:b] = d
        w = c.to(torch.int64) & _MASK32
        rows = torch.stack(
            [
                (d != 0).sum(dim=1),
                w.sum(dim=1) & _MASK32,
                ((w * idx) & _MASK32).sum(dim=1) & _MASK32,
            ],
            dim=1,
        )
        meta[a:b] = int32_bits(rows)
    return delta, meta


def fused_precodec(
    cur: torch.Tensor, base: torch.Tensor, *, chunk_words: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused delta + dirty-count + checksum over chunked word streams.

    ``cur``/``base``: equal-length 1-D ``int32`` tensors. The stream is
    taken as zero-padded to a chunk multiple (padding is neutral for both
    the dirty count and the checksum tracks). Returns ``(delta, meta)``:
    ``delta`` is ``(n_chunks, chunk_words)`` int32 and ``meta`` is
    ``(n_chunks, 3)`` int32 rows of ``(changed_words, S, T)``, each read
    as uint32.
    """
    _check_args(cur, base, chunk_words)
    if on_cpu([cur, base]):
        return fused_precodec_plain(cur, base, chunk_words=chunk_words)
    check_operand(cur, "cur", torch.int32)
    check_operand(base, "base", torch.int32)
    n = cur.numel()
    n_chunks = -(-n // chunk_words)
    delta = torch.empty((n_chunks, chunk_words), dtype=torch.int32, device=cur.device)
    meta = torch.zeros((n_chunks, 3), dtype=torch.int32, device=cur.device)
    if n_chunks == 0:
        return delta, meta
    launch = load("fused_precodec")
    with torch.cuda.device(cur.device):
        err = launch(
            cur.data_ptr(), base.data_ptr(), delta.data_ptr(), meta.data_ptr(),
            n, chunk_words, n_chunks, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"fused_precodec kernel launch failed: CUDA error {err}")
    count_launch(fused_precodec)
    return delta, meta


fused_precodec.launches = 0


def meta_to_numpy(meta: torch.Tensor) -> np.ndarray:
    """(n_chunks, 3) int32 meta tensor -> host uint32 array (same bits)."""
    return u32_numpy(meta)


def digests_from_meta(meta: np.ndarray) -> np.ndarray:
    """(n_chunks, 3) uint32 meta rows -> (n_chunks,) uint64 digests."""
    m = np.asarray(meta, dtype=np.uint64)
    return (m[:, 2] << np.uint64(32)) | m[:, 1]


def dirty_from_meta(meta: np.ndarray) -> np.ndarray:
    """(n_chunks, 3) uint32 meta rows -> (n_chunks,) bool dirty mask."""
    return np.asarray(meta)[:, 0] > 0
