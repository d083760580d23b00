"""Partition-spec rules: map every param/batch/cache leaf to mesh axes.

Counterpart of ``repro/models/sharding.py``, with its rules and names.
Scheme: FSDP over ("pod", "data") — weights sharded on a feature dim,
gathered just in time — and tensor parallelism over "model". Rules are
name+rank based and *divisibility-guarded*: a dim is only sharded by
axes whose size product divides it (e.g. whisper's vocab 51865 stays
unsharded; 10-head attention replicates heads but still shards d_ff).

A spec is a :class:`P`: a tuple with one entry per tensor dim, each
``None``, an axis name or a tuple of axis names, as a JAX
``PartitionSpec`` is (a one-name tuple is stored as the name, as there).
:func:`to_placements` turns a spec into DTensor placements, one per mesh
dim. The rules read a mesh only through :func:`mesh_shape` (axis name ->
size), so they take a ``DeviceMesh`` or a plain mapping of the mesh's
shape (tests, the dry run) alike.
"""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils.treelib import flatten_with_names, tree_map, unflatten


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``'s counterpart):
    ``P(None, "model")``, ``P(("pod", "data"), None)``; ``P()`` replicates.
    A leaf of a spec tree (pass ``is_leaf=is_spec`` to the tree helpers)."""

    def __new__(cls, *entries):
        return super().__new__(
            cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)
        )

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)
    or of a mapping that already is one, in mesh-dim order."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dim names")
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: P, mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    mesh dim that shards tensor dim d is ``Shard(d)``, every other one
    ``Replicate()``. Axes that share a tensor dim shard it in mesh-dim
    order (``("pod", "data")``: pod outermost), as GSPMD does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} of dim {d} out of mesh order {names}")
        for i in dims:
            placements[i] = Shard(d)
    return tuple(placements)


# ---------------------------------------------------------------------------
# Activation-sharding context: model code calls shard_act(x, "dp", None,
# "tp") at layer boundaries; the pins are no-ops unless a harness has
# activated a mesh, and then act on DTensor activations only (a plain
# tensor is returned as it is: the port's step runs on plain tensors).
# ---------------------------------------------------------------------------

_ACT_RULES: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "repro_torch_act_rules", default=None
)


@contextmanager
def activation_sharding(mesh: Any):
    """Enable activation pins (and ``tp_size``) for this mesh."""
    rules = {
        "dp": fsdp_axes(mesh),
        "tp": "model",
        "sizes": mesh_shape(mesh),
    }
    token = _ACT_RULES.set(rules)
    try:
        yield
    finally:
        _ACT_RULES.reset(token)


def tp_size() -> int:
    """Active TP degree (1 when no mesh context is active)."""
    rules = _ACT_RULES.get()
    if rules is None:
        return 1
    return int(rules["sizes"].get(rules["tp"], 1))


def shard_act(x, *kinds):
    """Constrain activation dims: kinds from {"dp", "tp", None} per dim.

    Divisibility-guarded: an axis that does not divide the dim is
    dropped (e.g. 10-head attention under 16-way TP replicates heads).
    A DTensor is redistributed to the pinned layout; a plain tensor is
    returned unchanged.
    """
    rules = _ACT_RULES.get()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = rules["sizes"]

    def ok(dim: int, axes) -> Optional[Any]:
        if axes is None:
            return None
        seq = (axes,) if isinstance(axes, str) else tuple(axes)
        prod = 1
        for a in seq:
            prod *= sizes.get(a, 1)
        if dim % prod == 0:
            return axes
        for k in range(len(seq) - 1, 0, -1):
            prod = 1
            for a in seq[:k]:
                prod *= sizes.get(a, 1)
            if dim % prod == 0:
                return seq[:k]
        return None

    spec = P(*[ok(x.shape[i], rules.get(k) if k else None) for i, k in enumerate(kinds)])
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


# leaf-name fragments whose *first* big axis is the contraction output
# (down-projections: shard input dim by TP, output dim by FSDP)
_DOWN_NAMES = ("w_down", "wo", "m_down", "w_out", "shared_down")
_REPLICATE_NAMES = (
    "ln", "final_norm", "gn", "_s']", "_b']", "conv_b", "lam", "b_r", "b_i",
    "bq", "bk", "bv", "bo", "b_in", "b_out", "['b']", "['r']", "enc_pos",
    "dec_pos", "pos",
)


def axis_size(mesh: Any, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(math.prod(shape[a] for a in axes))


def fsdp_axes(mesh: Any):
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _maybe(dim: int, axes, mesh: Any):
    """axes if they evenly divide dim else None."""
    if axes is None:
        return None
    if dim % axis_size(mesh, axes) == 0:
        return axes
    # try a prefix (e.g. ("pod","data") -> ("pod",))
    if not isinstance(axes, str) and len(axes) > 1:
        for k in range(len(axes) - 1, 0, -1):
            sub = axes[:k]
            if dim % axis_size(mesh, sub) == 0:
                return sub
    return None


def param_spec_for(name: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh: Any) -> P:
    F = fsdp_axes(mesh)
    T = "model"
    if any(frag in name for frag in _REPLICATE_NAMES):
        return P()
    if "embed" in name:
        # Lookup table: vocab over TP, d replicated (the reference's rule:
        # a d-sharded gather output miscompiles in its CPU partitioner).
        v, d = shape
        return P(_maybe(v, T, mesh), None)
    if "'out'" in name or name.endswith("out']") and "w_out" not in name:
        v, d = shape
        return P(_maybe(v, T, mesh), _maybe(d, F, mesh))
    if "router" in name:
        return P(None, _maybe(shape[-2], F, mesh), None)
    # MoE expert stacks: (L, E, a, b)
    if len(shape) == 4 and cfg.moe is not None and "moe" in name:
        L, E, a, b = shape
        ep = _maybe(E, T, mesh)
        if ep is not None:
            return P(None, ep, _maybe(a, F, mesh), None)
        # expert-TP fallback: shard the expert feature dims
        if any(frag in name for frag in _DOWN_NAMES):
            return P(None, None, _maybe(a, T, mesh), _maybe(b, F, mesh))
        return P(None, None, _maybe(a, F, mesh), _maybe(b, T, mesh))
    down = any(frag in name for frag in _DOWN_NAMES)
    if len(shape) == 3:  # stacked layers: (L, a, b)
        _, a, b = shape
        if down:
            return P(None, _maybe(a, T, mesh), _maybe(b, F, mesh))
        return P(None, _maybe(a, F, mesh), _maybe(b, T, mesh))
    if len(shape) == 2:  # per-layer dict weights (xlstm/griffin lists)
        a, b = shape
        if "conv_w" in name:
            return P(None, _maybe(b, T, mesh))
        if down:
            return P(_maybe(a, T, mesh), _maybe(b, F, mesh))
        return P(_maybe(a, F, mesh), _maybe(b, T, mesh))
    if len(shape) == 1:
        return P()
    return P()


def param_specs(model, mesh: Any) -> Any:
    struct = model.param_struct()
    named_leaves, treedef = flatten_with_names(struct)
    specs = [
        param_spec_for(name, tuple(leaf.shape), model.cfg, mesh)
        for name, leaf in named_leaves
    ]
    return unflatten(treedef, specs)


# ---------------------------------------------------------------------------
# batch / cache / optimizer specs
# ---------------------------------------------------------------------------


def batch_specs(model, mesh: Any) -> Any:
    F = fsdp_axes(mesh)

    def spec(name: str, leaf) -> P:
        rank = len(leaf.shape)
        dp = _maybe(leaf.shape[0], F, mesh)
        return P(dp, *([None] * (rank - 1)))

    struct = model.batch_struct(8 * axis_size(mesh, fsdp_axes(mesh)), 128)
    named_leaves, treedef = flatten_with_names(struct)
    return unflatten(treedef, [spec(n, l) for n, l in named_leaves])


def cache_spec_for(name: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh: Any) -> P:
    F = fsdp_axes(mesh)
    T = "model"
    if name.endswith("pos']") or "slot_pos" in name or shape == ():
        return P()
    # transformer / whisper stacked caches: (L, B, S, H_kv, hd)
    if len(shape) == 5:
        _, b, _, h_kv, hd = shape
        return P(
            None, _maybe(b, F, mesh), None, _maybe(h_kv, T, mesh),
            None if _maybe(h_kv, T, mesh) else _maybe(hd, T, mesh),
        )
    # xlstm: C (B,H,hd,hd) / conv (B,W,di) / n (B,H,hd) / m (B,H)
    if len(shape) == 4:
        b, h, hd, _ = shape
        return P(_maybe(b, F, mesh), _maybe(h, T, mesh),
                 None if _maybe(h, T, mesh) else _maybe(hd, T, mesh), None)
    if len(shape) == 3:
        b = shape[0]
        return P(_maybe(b, F, mesh), None, _maybe(shape[-1], T, mesh))
    if len(shape) == 2:
        b = shape[0]
        return P(_maybe(b, F, mesh), _maybe(shape[-1], T, mesh))
    if len(shape) == 1:
        return P(None)
    return P()


def cache_specs(model, mesh: Any, b: int, s_max: int) -> Any:
    struct = model.cache_struct(b, s_max)
    named_leaves, treedef = flatten_with_names(struct)
    specs = []
    for name, leaf in named_leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        specs.append(cache_spec_for(name, shape, model.cfg, mesh))
    return unflatten(treedef, specs)


def named(tree: Any, mesh: Any, specs: Any) -> Any:
    """The DTensor placements of every spec (the reference attaches
    ``NamedSharding``\\ s). ``tree`` is not read, as in the reference."""
    return tree_map(lambda s: to_placements(s, mesh), specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# placing tensors (the reference's ``device_put`` onto a NamedSharding)
# ---------------------------------------------------------------------------


def local_shard(x: torch.Tensor, mesh: Any, placements) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``placements``
    (a view of ``x``; ``x`` itself when nothing is sharded)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, placements)
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != x.shape[d]:
            x = x.narrow(d, o, n)
    return x


def place(tree: Any, mesh: Any, specs: Any) -> Any:
    """Every whole tensor of ``tree`` as a DTensor on ``mesh`` laid out
    by its spec in ``specs`` (a tree of the same structure). Each rank
    keeps its own shard, cut from its copy of the whole tensor with no
    communication; on a mesh of one device the shard is the tensor
    itself, with no copy."""
    from torch.distributed.tensor import DTensor

    leaves, treedef = flatten_with_names(tree)
    spec_leaves = [s for _, s in flatten_with_names(specs, is_leaf=is_spec)[0]]
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(spec_leaves)} specs")
    out = []
    for (_, x), spec in zip(leaves, spec_leaves):
        pl = to_placements(spec, mesh)
        x = x.detach()
        local = local_shard(x, mesh, pl)
        if local is not x:
            local = local.clone()   # do not keep the whole tensor alive
        out.append(DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=x.shape, stride=x.stride()))
    return unflatten(treedef, out)
