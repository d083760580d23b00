"""The two-track checksum of a whole word stream, and the digests built on it.

Counterpart of ``repro/kernels/checksum/{checksum,ops}.py``. Words are
``int32`` tensors whose 32 bits are read as uint32 (torch has few uint32
operations); :func:`checksum_u32` returns ``(S, T)`` as a ``(2,)`` int32
tensor with the same bits, which :func:`checksum_pair` reads as two
Python ints. The definition is in :mod:`repro_torch.kernels.checksum.ref`.

On a CUDA tensor :func:`checksum_u32` launches ``csrc/checksum.cu``; on
a CPU tensor it runs :func:`checksum_u32_plain`, the same function in
plain PyTorch.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checksum.ref import IDX_MOD
from repro_torch.kernels.common import (
    bytes_to_u32,
    check_operand,
    count_launch,
    int32_bits,
    on_cpu,
    resolve_device,
    u32_numpy,
)

_MASK32 = 0xFFFFFFFF
# words per group in the plain version (bounds its int64 temporaries)
_PLAIN_GROUP_WORDS = 1 << 26


def _check_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.int32:
        raise TypeError(f"words: expected torch.int32, got {words.dtype}")
    return words.reshape(-1)


def checksum_u32_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    uint32 arithmetic is done in int64 and masked to 32 bits, a group
    of words at a time: each product ``(i mod 2**20) * w`` is below
    2**52 and is masked before the sum, so no int64 sum overflows.
    """
    w32 = _check_words(words)
    dev = w32.device
    s = torch.zeros((), dtype=torch.int64, device=dev)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, w32.numel(), _PLAIN_GROUP_WORDS):
        w = w32[lo : lo + _PLAIN_GROUP_WORDS].to(torch.int64) & _MASK32
        idx = torch.arange(lo, lo + w.numel(), dtype=torch.int64, device=dev)
        idx &= IDX_MOD - 1
        s = (s + w.sum()) & _MASK32
        t = (t + ((w * idx) & _MASK32).sum()) & _MASK32
    return int32_bits(torch.stack([s, t]))


def checksum_u32(words: torch.Tensor) -> torch.Tensor:
    """Two-track checksum of a stream of ``int32`` words (read as
    uint32) -> ``(2,)`` int32 tensor ``(S, T)`` on the words' device.

    An empty stream gives zeros without a launch. On the card the words
    need only 4-byte alignment (a view into a leaf is fine): the kernel
    reads the words before the first 16-byte boundary one by one.
    """
    w = _check_words(words)
    if on_cpu([w]):
        return checksum_u32_plain(w)
    out = torch.zeros((2,), dtype=torch.int32, device=w.device)
    if w.numel() == 0:
        return out
    check_operand(w, "words", torch.int32, align=4)
    launch = load("checksum")
    with torch.cuda.device(w.device):
        err = launch(
            w.data_ptr(), out.data_ptr(), w.numel(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"checksum kernel launch failed: CUDA error {err}")
    count_launch(checksum_u32)
    return out


checksum_u32.launches = 0


def checksum_pair(st: torch.Tensor) -> Tuple[int, int]:
    """A ``(2,)`` int32 checksum tensor -> ``(S, T)`` as uint32 ints."""
    s, t = u32_numpy(st)
    return int(s), int(t)


def digest_of(st: torch.Tensor) -> int:
    """A ``(2,)`` int32 checksum tensor -> the digest ``(T << 32) | S``."""
    s, t = checksum_pair(st)
    return (t << 32) | s


def digest_bytes(data: bytes, *, device: Any = "cuda") -> int:
    """Digest ``(T << 32) | S`` of a byte string, zero-padded to whole
    words, computed on ``device``."""
    words = bytes_to_u32(data).to(resolve_device(device))
    return digest_of(checksum_u32(words))


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as ``int32`` words, as JAX's ``_as_u32`` has them:
    4-byte dtypes reinterpreted; 1- and 2-byte dtypes zero-padded to a
    whole word, then reinterpreted; 8-byte dtypes as two little-endian
    32-bit limbs each."""
    x = x.reshape(-1)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    isz = x.element_size()
    if isz < 4:
        per = 4 // isz
        pad = (-x.numel()) % per
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        elif x.storage_offset() % per:
            x = x.clone()   # a view must start on a whole word
    return x.view(torch.int32)


def digest_array(x: torch.Tensor) -> torch.Tensor:
    """Checksum ``(S, T)`` of a tensor's bytes on its own device: the
    pre-D2H integrity check of the flush path. ``(2,)`` int32 tensor."""
    return checksum_u32(_as_words(x))
