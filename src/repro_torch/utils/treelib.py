"""Pytree helpers: named leaves in JAX's order, without JAX.

Counterpart of ``repro/utils/treelib.py``. A tree is made of dicts,
lists, tuples and ``None``; anything else is a leaf. Leaves come out in
the order ``jax.tree_util.tree_flatten_with_path`` gives and are named
as ``jax.tree_util.keystr`` names them (``"['params']['w'][0]"``): dict
keys sorted (an ``OrderedDict`` keeps its own order), sequences in index
order, ``None`` an empty node. Stream offsets, the manifest leaf table
and the name check on restore all depend on that order, so a state
saved by either package restores in the other. (``torch.utils._pytree``
keeps dict insertion order, which is why it is not used.)
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple

# A treedef is a hashable nested tuple:
#   _LEAF | ("none",) | (kind, keys, children) for dicts | (kind, children)
_LEAF = ("leaf",)
_NONE = ("none",)
IsLeaf = Optional[Callable[[Any], bool]]


def _flatten(x: Any, path: str, out: List[Tuple[str, Any]], is_leaf: IsLeaf):
    if is_leaf is not None and is_leaf(x):
        out.append((path, x))
        return _LEAF
    if x is None:
        return _NONE
    if isinstance(x, dict):
        ordered = isinstance(x, OrderedDict)
        keys = tuple(x) if ordered else tuple(sorted(x))
        kind = OrderedDict if ordered else dict
        return (
            kind,
            keys,
            tuple(_flatten(x[k], f"{path}[{k!r}]", out, is_leaf) for k in keys),
        )
    if isinstance(x, (list, tuple)):
        return (
            list if isinstance(x, list) else tuple,
            tuple(
                _flatten(v, f"{path}[{i}]", out, is_leaf) for i, v in enumerate(x)
            ),
        )
    out.append((path, x))
    return _LEAF


def flatten_with_names(
    tree: Any, is_leaf: IsLeaf = None
) -> Tuple[List[Tuple[str, Any]], Any]:
    """``[(keystr name, leaf), ...]`` in JAX's leaf order, and the treedef."""
    out: List[Tuple[str, Any]] = []
    treedef = _flatten(tree, "", out, is_leaf)
    return out, treedef


def tree_leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree, is_leaf)[0]]


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Rebuild a tree of ``treedef``'s structure from ``leaves`` in order."""
    it = iter(leaves)

    def build(td):
        if td == _LEAF:
            return next(it)
        if td == _NONE:
            return None
        if len(td) == 3:
            kind, keys, children = td
            d = {k: build(c) for k, c in zip(keys, children)}
            return d if kind is dict else OrderedDict(d)
        kind, children = td
        seq = [build(c) for c in children]
        return seq if kind is list else kind(seq)

    tree = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef has")
    return tree


def tree_map(fn: Callable[[Any], Any], tree: Any, is_leaf: IsLeaf = None) -> Any:
    named, treedef = flatten_with_names(tree, is_leaf)
    return unflatten(treedef, [fn(leaf) for _, leaf in named])

