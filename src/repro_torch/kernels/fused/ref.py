"""Numpy oracle for the fused delta+dirty+checksum chunk pass.

Pure numpy (no jax) so it can double as the host-side verifier: the
engine's digest column check recomputes exactly this per decoded chunk.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.checksum.ref import IDX_MOD

_MASK32 = np.uint64(0xFFFFFFFF)


def _pad_chunks(w: np.ndarray, chunk_words: int) -> np.ndarray:
    w = np.ascontiguousarray(w, dtype=np.uint32).reshape(-1)
    rem = (-w.size) % chunk_words
    if rem:
        w = np.concatenate([w, np.zeros(rem, dtype=np.uint32)])
    return w.reshape(-1, chunk_words)


def chunk_digests_ref(words: np.ndarray, chunk_words: int) -> np.ndarray:
    """Per-chunk ``(T << 32) | S`` two-track digests, zero-padded tail.

    Matches ``repro_torch.kernels.checksum.ref.digest_ref`` applied to each
    chunk's words in isolation (the index track restarts at every chunk
    boundary).  Accumulation is plain uint64 arithmetic: products are at
    most ``2**52`` and the final ``& 0xffffffff`` is exact under mod-2**64
    wrap-around because ``2**32`` divides ``2**64``.
    """
    c = _pad_chunks(words, chunk_words).astype(np.uint64)
    idx = (np.arange(chunk_words, dtype=np.uint64) % np.uint64(IDX_MOD))
    s = c.sum(axis=1) & _MASK32
    t = (c * idx[None, :]).sum(axis=1) & _MASK32
    return (t << np.uint64(32)) | s


def fused_ref(cur: np.ndarray, base: np.ndarray, chunk_words: int):
    """Oracle for ``fused_precodec``.

    Returns ``(delta, counts, digests)`` where ``delta`` is the XOR of
    the zero-padded streams shaped ``(n_chunks, chunk_words)`` uint32,
    ``counts`` the per-chunk changed-word totals (uint32) and
    ``digests`` the per-chunk two-track digests of *cur* (uint64).
    """
    c = _pad_chunks(cur, chunk_words)
    b = _pad_chunks(base, chunk_words)
    if c.shape != b.shape:
        raise ValueError(f"stream length mismatch: {c.shape} vs {b.shape}")
    d = np.bitwise_xor(c, b)
    counts = (d != 0).sum(axis=1).astype(np.uint32)
    return d, counts, chunk_digests_ref(c, chunk_words)
