"""XOR delta of two word streams and its changed-word count.

Counterpart of ``repro/kernels/delta/{delta,ops}.py``. Streams are
``int32`` tensors whose bits are read as uint32 words.

On a CUDA tensor :func:`xor_delta` launches ``csrc/delta.cu``; on a CPU
tensor it runs :func:`xor_delta_plain`, the same function in plain
PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import check_operand, on_cpu

# words per group in the plain version (bounds its temporaries)
_PLAIN_GROUP_WORDS = 1 << 26


def _check_args(cur: torch.Tensor, prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    for name, t in (("cur", cur), ("prev", prev)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32, got {t.dtype}")
    c, p = cur.reshape(-1), prev.reshape(-1)
    if c.shape != p.shape:
        raise ValueError("delta requires equal-length streams")
    return c, p


def xor_delta_plain(
    cur: torch.Tensor, prev: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device."""
    c, p = _check_args(cur, prev)
    delta = torch.empty_like(c)
    count = torch.zeros((), dtype=torch.int64, device=c.device)
    for lo in range(0, c.numel(), _PLAIN_GROUP_WORDS):
        d = torch.bitwise_xor(
            c[lo : lo + _PLAIN_GROUP_WORDS], p[lo : lo + _PLAIN_GROUP_WORDS]
        )
        delta[lo : lo + d.numel()] = d
        count += (d != 0).sum()
    return delta, count


def xor_delta(
    cur: torch.Tensor, prev: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equal-length ``int32`` word streams -> ``(delta, count)``:
    ``delta`` the ``(n,)`` int32 XOR, ``count`` the number of words that
    differ as a 0-d int64 tensor on the streams' device (read it with
    ``int()`` when needed; the wrapper never synchronizes)."""
    c, p = _check_args(cur, prev)
    if on_cpu([c, p]):
        return xor_delta_plain(c, p)
    check_operand(c, "cur", torch.int32)
    check_operand(p, "prev", torch.int32)
    delta = torch.empty_like(c)
    count = torch.zeros((), dtype=torch.int64, device=c.device)
    if c.numel() == 0:
        return delta, count
    launch = load("xor_delta")
    with torch.cuda.device(c.device):
        err = launch(
            c.data_ptr(), p.data_ptr(), delta.data_ptr(), count.data_ptr(),
            c.numel(), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"xor_delta kernel launch failed: CUDA error {err}")
    xor_delta.launches += 1
    return delta, count


xor_delta.launches = 0
