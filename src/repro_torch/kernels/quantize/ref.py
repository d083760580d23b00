"""NumPy oracle for blockwise int8 quantization.

Block size = 128 values.  Per block: symmetric absmax scaling,

    scale = max(|x|) / 127          (scale 0 -> block of zeros)
    q     = round_half_away(x / scale)  clipped to [-127, 127]
    x'    = q * scale

Round-half-away-from-zero (not banker's rounding), so the kernel and the
oracle agree bit-exactly on ties across backends. As in the reference,
``quantize_ref`` adds the +-0.5 in float64 (``np.where`` of Python
floats), so 0.49999997 rounds to 0 here and to 1 in the kernel, which
adds in float32.
"""
from __future__ import annotations

import numpy as np

BLOCK = 128


def quantize_ref(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """x: (n_blocks, BLOCK) float -> (q int8 same shape, scales (n_blocks,) f32)."""
    xf = np.asarray(x, dtype=np.float32)
    absmax = np.abs(xf).max(axis=-1)
    scale = absmax / 127.0
    safe = np.where(scale > 0, scale, 1.0)[:, None]
    q = np.trunc(xf / safe + np.where(xf >= 0, 0.5, -0.5))
    q = np.clip(q, -127, 127).astype(np.int8)
    q = np.where(scale[:, None] > 0, q, 0).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_ref(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return (q.astype(np.float32) * np.asarray(scale, np.float32)[:, None]).astype(
        np.float32
    )
