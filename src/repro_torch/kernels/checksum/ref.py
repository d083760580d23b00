"""NumPy oracle for the two-track chunked checksum.

Definition (TPU-adapted Fletcher-64 style — see DESIGN.md §3): over
uint32 words ``w_i``, with all arithmetic mod 2^32 (natural unsigned
wrap; end-around carry mod 2^32-1 has no efficient vectorized form on
the TPU VPU):

    S = sum_i w_i                    (content track)
    T = sum_i (i mod 2^20) * w_i     (position track)

The digest is ``(T << 32) | S``.  Any single-bit flip changes S; any
swap/move of words changes T.  The position index is reduced mod 2^20 so
the per-tile index weights are exact in uint32 for tiles up to 2^12
words (products < 2^32 never lose information before the deliberate
wrap-around accumulation).
"""
from __future__ import annotations

import numpy as np

IDX_MOD = 1 << 20


def checksum_ref_np(words: np.ndarray) -> tuple[int, int]:
    w = np.ascontiguousarray(words, dtype=np.uint32)
    idx = (np.arange(w.size, dtype=np.uint64) % IDX_MOD).astype(np.uint32)
    s = int(np.add.reduce(w, dtype=np.uint64) & 0xFFFFFFFF)
    # exact products in uint64, wrap the accumulation to 32 bits
    t = int((np.multiply(idx.astype(np.uint64), w.astype(np.uint64))).sum() & 0xFFFFFFFF)
    return s, t


def digest_ref(words: np.ndarray) -> int:
    s, t = checksum_ref_np(words)
    return (t << 32) | s
