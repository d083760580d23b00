"""NumPy oracle for the XOR-delta kernel (incremental checkpoints).

delta = cur XOR prev (uint32 words); the count of changed words is the
side output that tells the engine whether a delta is worth compressing.
"""
from __future__ import annotations

import numpy as np


def delta_ref(cur: np.ndarray, prev: np.ndarray) -> tuple[np.ndarray, int]:
    c = np.ascontiguousarray(cur, np.uint32)
    p = np.ascontiguousarray(prev, np.uint32)
    d = np.bitwise_xor(c, p)
    return d, int(np.count_nonzero(d))
