"""Blockwise int8 quantization of float tensors.

Counterpart of ``repro/kernels/quantize/{quantize,ops}.py``. The input
is flattened, cast to float32 and zero-padded to a multiple of ``TILE``
(4096 values, the reference kernel's (32, 128) tile), so the block count
matches the reference; padding blocks quantize to zero scale.

On a CUDA tensor the wrapper launches ``csrc/quantize.cu``; on a CPU
tensor it runs :func:`quantize_plain`, the same function in plain
PyTorch. Both do each step as one IEEE float32 operation, as the Pallas
kernel does, so codes and scales are bit-identical.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.common import check_operand, on_cpu, pad_to_multiple

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
    quantize.launches += 1
    return q, s


quantize.launches = 0


def quantize_blocks_needed(n: int) -> int:
    padded = n + ((-n) % TILE)
    return padded // BLOCK
