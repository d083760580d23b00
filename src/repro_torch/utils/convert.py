"""Carry states between NumPy pytrees and the port's torch tensors.

The JAX package's states and restores come out as pytrees of NumPy
arrays (``np.asarray`` of each ``jax.Array``). :func:`tree_from_numpy`
turns such a tree into torch tensors on a device, and
:func:`tree_to_numpy` turns the port's tensors back. NumPy has no
bfloat16 of its own, so bf16 moves through a 16-bit storage view: the
NumPy side names it ``bfloat16`` (the dtype that ``ml_dtypes``
registers), the torch side ``torch.bfloat16``. Structure and leaf order
are kept (see :mod:`repro_torch.utils.treelib`). A DTensor leaf (a
state placed on a mesh) is read as its whole tensor (:func:`whole_tensor`).

:func:`params_from_numpy` and :func:`train_state_from_numpy` load a JAX
parameter or train-state tree into the port's model module of the
config's family and its optimizer state, the MoE family's nested
``layers.moe`` leaves (a float32 router beside bfloat16 params, with
float32 moments), the recurrent families' ``blocks`` lists and
whisper's ``enc_layers``/``dec_layers`` stacks included;
:func:`copy_tree_` loads any tree into another in place (a restore into
a live train state). :func:`cache_from_numpy` and :func:`cache_to_numpy`
carry a decode cache between the packages: the transformer's
``DecodeCache`` (``k``, ``v``, ``pos``), whisper's ``WhisperCache``
(``k``, ``v``, ``xk``, ``xv``, ``pos``) or a recurrent state (dicts,
lists of dicts and a ``pos``).
"""
from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from repro_torch.utils.treelib import flatten_with_names, tree_map


def _numpy_bfloat16() -> np.dtype:
    try:
        return np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError(
            "numpy knows no 'bfloat16' dtype in this process "
            "(it is registered by the ml_dtypes package)"
        ) from e


def whole_tensor(x: Any) -> Any:
    """A DTensor's whole tensor: its local tensor (no copy) on a mesh of
    one device, else ``full_tensor()``, a collective that every rank of
    the mesh calls. Anything else is returned as it is."""
    # no DTensor exists before its module is imported (which takes a
    # second): a plain state never pays for it
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x
    with torch.no_grad():
        return x.to_local() if x.device_mesh.size() == 1 else x.full_tensor()


def _from_numpy(x: Any, device: torch.device) -> torch.Tensor:
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = whole_tensor(t).detach().cpu().contiguous()
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


@torch.no_grad()
def copy_tree_(dst: Any, src: Any) -> Any:
    """Copy every leaf of ``src`` (tensors or NumPy arrays) into the
    leaf of ``dst`` with the same name, in place; returns ``dst``.
    Names, shapes and dtypes must agree."""
    dn, sn = flatten_with_names(dst)[0], flatten_with_names(src)[0]
    if [n for n, _ in dn] != [n for n, _ in sn]:
        raise ValueError("trees differ in structure")
    for (name, d), (_, s) in zip(dn, sn):
        if not isinstance(s, torch.Tensor):
            s = _from_numpy(s, torch.device("cpu"))
        if d.dtype != s.dtype or tuple(d.shape) != tuple(s.shape):
            raise ValueError(
                f"leaf {name}: {s.dtype}{tuple(s.shape)} into {d.dtype}{tuple(d.shape)}"
            )
        d.copy_(s)
    return dst


def params_from_numpy(tree: Any, model_or_cfg: Any, device: Any = "cuda") -> Any:
    """A JAX parameter tree (NumPy leaves) as the port's model module.

    ``model_or_cfg`` is a module (loaded in place and returned), a
    ``Model`` or a ``ModelConfig`` (a new module of the config's family
    is made on ``device``)."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.api import get_model

    if isinstance(model_or_cfg, torch.nn.Module):
        module = model_or_cfg
    else:
        cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
        module = get_model(cfg).build(resolve_device(device))
    copy_tree_(module.state_tree(), tree)
    return module


def train_state_from_numpy(tree: Any, model_or_cfg: Any, device: Any = "cuda") -> Any:
    """A JAX train state ``{"params", "opt": {"mu", "nu", "count"},
    "step"}`` (NumPy leaves) as the port's train state: ``params`` are a
    model module's own parameters, the rest tensors on the same device."""
    module = params_from_numpy(tree["params"], model_or_cfg, device)
    dev = module.embed.device
    return {
        "params": module.state_tree(),
        "opt": {
            "mu": tree_from_numpy(tree["opt"]["mu"], dev),
            "nu": tree_from_numpy(tree["opt"]["nu"], dev),
            "count": _from_numpy(tree["opt"]["count"], dev),
        },
        "step": _from_numpy(tree["step"], dev),
    }


def cache_from_numpy(cache: Any, device: Any = "cuda") -> Any:
    """A decode cache with NumPy leaves as the port's on ``device``: a
    named tuple by its fields (the JAX package's or the port's own), a
    ``(k, v, pos)`` one as the port's
    :class:`~repro_torch.models.transformer.DecodeCache` and a ``(k, v,
    xk, xv, pos)`` one as :class:`~repro_torch.models.whisper.WhisperCache`;
    a recurrent state (``{"layers": [...], "pos"}``) as the same tree of
    tensors."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.transformer import DecodeCache
    from repro_torch.models.whisper import WhisperCache

    dev = resolve_device(device)
    fields = getattr(type(cache), "_fields", None)
    if fields is not None:
        kind = {c._fields: c for c in (DecodeCache, WhisperCache)}[fields]
        return kind(*(_from_numpy(x, dev) for x in cache))
    return tree_from_numpy(cache, dev)


def cache_to_numpy(cache: Any) -> Any:
    """The port's cache with host NumPy leaves, in the same structure (so
    ``repro.models.transformer.DecodeCache(*cache_to_numpy(c))`` or
    ``repro.models.whisper.WhisperCache(*cache_to_numpy(c))`` feeds the
    JAX package, and a recurrent state's dicts go as they are)."""
    return tree_to_numpy(cache)
