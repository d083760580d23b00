"""Shared helpers for the port's kernel wrappers.

Counterpart of ``repro/kernels/common.py``. There the Pallas kernels ran
in interpret mode off the TPU; here each wrapper decides by the device
of the tensors it is given: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the CUDA kernel (built by
:mod:`repro_torch.kernels.build`) or raises. There is no fallback from a
CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Sequence

import torch


def on_cpu(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor whose data
    starts on a 16-byte boundary (what the kernels' vector loads need)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data is not 16-byte aligned")


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to a length that is a multiple of ``multiple``."""
    pad = (-x.numel()) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(pad)])

