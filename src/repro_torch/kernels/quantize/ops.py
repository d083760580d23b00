"""Blockwise int8 quantization of float tensors, and its inverse.

Counterpart of ``repro/kernels/quantize/{quantize,ops}.py``. The input
is flattened, cast to float32 and zero-padded to a multiple of ``TILE``
(4096 values, the reference kernel's (32, 128) tile), so the block count
matches the reference; padding blocks quantize to zero scale.

On a CUDA tensor :func:`quantize` launches ``csrc/quantize.cu`` and
:func:`dequantize` ``csrc/dequantize.cu``; on a CPU tensor they run
:func:`quantize_plain` and :func:`dequantize_plain`, the same functions
in plain PyTorch. All of them do each step as one IEEE float32
operation, as the Pallas kernels do, so codes, scales and values are
bit-identical.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import (
    check_operand,
    count_launch,
    on_cpu,
    pad_to_multiple,
)

ROWS = 32     # blocks per tile of the reference kernel
BLOCK = 128   # values per quantization block
TILE = ROWS * BLOCK
# blocks per group in the plain version (bounds its temporaries)
_PLAIN_GROUP_BLOCKS = 1 << 19


def quantize_plain(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(n_blocks, 128)`` float32
    -> ``(q int8 (n_blocks, 128), scales (n_blocks,) f32)``, on any
    device."""
    n = blocks.shape[0]
    q = torch.empty((n, BLOCK), dtype=torch.int8, device=blocks.device)
    s = torch.empty((n,), dtype=torch.float32, device=blocks.device)
    for a in range(0, n, _PLAIN_GROUP_BLOCKS):
        x = blocks[a : a + _PLAIN_GROUP_BLOCKS]
        absmax = x.abs().amax(dim=1)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which is not IEEE division
        scale = absmax / torch.full_like(absmax, 127.0)
        live = scale > 0
        safe = torch.where(live, scale, torch.ones_like(scale))
        r = torch.trunc(x / safe[:, None] + torch.where(x >= 0, 0.5, -0.5))
        r = r.clamp(-127.0, 127.0)
        q[a : a + len(x)] = torch.where(live[:, None], r, torch.zeros_like(r)).to(
            torch.int8
        )
        s[a : a + len(x)] = scale
    return q, s


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape float tensor -> (q int8 (n_blocks, 128), scales (n_blocks,) f32).

    Flattens and zero-pads to a tile multiple; padding blocks quantize
    to zero scale and are dropped by dequantize (which knows the
    original size).
    """
    flat = pad_to_multiple(x.reshape(-1).to(torch.float32), TILE)
    blocks = flat.view(-1, BLOCK)
    if on_cpu([blocks]):
        return quantize_plain(blocks)
    check_operand(blocks, "x", torch.float32)
    n = blocks.shape[0]
    q = torch.empty((n, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    launch = load("quantize")
    with torch.cuda.device(x.device):
        err = launch(
            blocks.data_ptr(), q.data_ptr(), s.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    count_launch(quantize)
    return q, s


quantize.launches = 0


def _check_dequant_args(q: torch.Tensor, s: torch.Tensor, n: int) -> None:
    if q.dim() != 2 or q.shape[1] != BLOCK or s.shape != (q.shape[0],):
        raise ValueError(
            f"need q (n_blocks, {BLOCK}) and s (n_blocks,), got "
            f"{tuple(q.shape)} and {tuple(s.shape)}"
        )
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"need int8 codes and float32 scales, got {q.dtype}, {s.dtype}")
    if not 0 <= n <= q.numel():
        raise ValueError(f"n={n} is outside [0, {q.numel()}]")


def dequantize_plain(q: torch.Tensor, s: torch.Tensor, *, n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: ``q * s`` per
    block as one float32 multiply, the first ``n`` values."""
    _check_dequant_args(q, s, n)
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    used = -(-n // BLOCK)
    for a in range(0, used, _PLAIN_GROUP_BLOCKS):
        b = min(a + _PLAIN_GROUP_BLOCKS, used)
        lo, hi = a * BLOCK, min(b * BLOCK, n)
        x = q[a:b].to(torch.float32) * s[a:b, None]
        out[lo:hi] = x.reshape(-1)[: hi - lo]
    return out


def dequantize(q: torch.Tensor, s: torch.Tensor, *, n: int) -> torch.Tensor:
    """``(q int8 (n_blocks, 128), s (n_blocks,) f32)`` -> the first ``n``
    values (the original element count) as a flat float32 tensor."""
    _check_dequant_args(q, s, n)
    if on_cpu([q, s]):
        return dequantize_plain(q, s, n=n)
    check_operand(q, "q", torch.int8, align=4)
    check_operand(s, "s", torch.float32, align=4)
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    launch = load("dequantize")
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error {err}")
    count_launch(dequantize)
    return out


dequantize.launches = 0


def quantize_blocks_needed(n: int) -> int:
    padded = n + ((-n) % TILE)
    return padded // BLOCK
