"""Seed (item-loop) serializer, kept verbatim as the executable spec
for :func:`repro_torch.core.serialize.serialize_tree`.

tests/test_torch_serialize.py holds the fast path to it and it to the
``repro`` package's own copy: the same logical stream and the same leaf
table.  The seed encoder and item-loop executor are specs of
``repro`` only; this package has neither.

Copy accounting of this path (what the zero-copy rewrite removes), for
a state of S bytes: per-leaf ``tobytes()`` (S bytes of temporaries)
plus the ``b"".join(chunks)`` recopy (S bytes, the stream).  The fast
path crosses memory once (pytree -> stream) and hands out views.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from repro_torch.core.serialize import LeafEntry, leaf_to_np
from repro_torch.utils.treelib import flatten_with_names


def serialize_tree_reference(state: Any) -> Tuple[bytes, List[LeafEntry]]:
    """The seed serializer: per-leaf ``tobytes()`` + one join recopy."""
    named, _ = flatten_with_names(state)
    chunks: List[bytes] = []
    leaves: List[LeafEntry] = []
    off = 0
    for name, leaf in named:
        arr, dtype = leaf_to_np(leaf)  # tobytes() emits C-order regardless of layout
        raw = arr.tobytes()
        leaves.append(
            LeafEntry(
                name=name, dtype=dtype, shape=tuple(arr.shape),
                offset=off, size=len(raw),
            )
        )
        chunks.append(raw)
        off += len(raw)
    return b"".join(chunks), leaves
