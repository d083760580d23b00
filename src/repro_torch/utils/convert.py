"""Carry states between NumPy pytrees and the port's torch tensors.

The JAX package's states and restores come out as pytrees of NumPy
arrays (``np.asarray`` of each ``jax.Array``). :func:`tree_from_numpy`
turns such a tree into torch tensors on a device, and
:func:`tree_to_numpy` turns the port's tensors back. NumPy has no
bfloat16 of its own, so bf16 moves through a 16-bit storage view: the
NumPy side names it ``bfloat16`` (the dtype that ``ml_dtypes``
registers), the torch side ``torch.bfloat16``. Structure and leaf order
are kept (see :mod:`repro_torch.utils.treelib`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.treelib import tree_map


def _numpy_bfloat16() -> np.dtype:
    try:
        return np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError(
            "numpy knows no 'bfloat16' dtype in this process "
            "(it is registered by the ml_dtypes package)"
        ) from e


def _from_numpy(x: Any, device: torch.device) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(_numpy_bfloat16())
    return t.numpy().copy()


def tree_from_numpy(tree: Any, device: Any) -> Any:
    """Every leaf of ``tree`` (NumPy arrays or scalars) as a torch tensor
    on ``device``, with the same dtype, shape and bytes."""
    dev = torch.device(device)
    return tree_map(lambda x: _from_numpy(x, dev), tree)


def tree_to_numpy(tree: Any) -> Any:
    """Every torch tensor leaf of ``tree`` as a host NumPy array with
    the same dtype, shape and bytes."""
    return tree_map(_to_numpy, tree)
