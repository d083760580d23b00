"""Shared helpers for the port's kernel wrappers.

Counterpart of ``repro/kernels/common.py``. There the Pallas kernels ran
in interpret mode off the TPU; here each wrapper decides by the device
of the tensors it is given: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the CUDA kernel (built by
:mod:`repro_torch.kernels.build`) or raises. There is no fallback from a
CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
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


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    there is no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device='cpu' to run on the host"
        )
    return dev


def check_operand(
    t: torch.Tensor, name: str, dtype: torch.dtype, align: int = 16
) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor whose data
    starts on an ``align``-byte boundary (16 for the kernels' uint4 and
    float4 vector loads)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data is not {align}-byte aligned")


def int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor whose words are read as uint32 -> host uint32
    array with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def bytes_to_u32(data: bytes) -> torch.Tensor:
    """A byte string as little-endian 32-bit words, zero-padded to a
    multiple of 4 bytes: a host ``int32`` tensor (read as uint32)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return torch.from_numpy(buf.view(np.int32).copy())


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to a length that is a multiple of ``multiple``."""
    pad = (-x.numel()) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(pad)])

