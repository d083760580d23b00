"""Named leaves of nested dict and list trees (tuples are leaves).

A leaf's name is its path, dict keys sorted, joined by ``/``:
``dec_layers/self/wq``, ``blocks/3/r``. The benchmark names the
program's trees and the references' with it, and matches leaves by
name.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, list):
        out = []
        for i, x in enumerate(tree):
            out += flatten(x, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves_by_name(tree: Any) -> dict:
    return dict(flatten(tree))
