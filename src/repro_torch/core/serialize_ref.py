"""Seed (item-loop) serialization path, kept verbatim as the executable
spec for the zero-copy encode pipeline in :mod:`repro_torch.core.serialize`.

Same pattern as :mod:`repro_torch.core.strategies_ref`: the original
implementation survives unchanged so the equivalence suite
(tests/test_save_phase.py) can prove the fast path byte-identical —
same logical stream, same rank blobs, same CRCs, same manifest — and so
``benchmarks/save_phase.py`` can measure the speedup against the real
pre-PR code instead of a synthetic stand-in.

Copy accounting of this path (what the zero-copy rewrite removes), for
a checkpoint of S bytes under codec ``none``:

* per-leaf ``tobytes()``            — S bytes of temporaries
* ``b"".join(chunks)``              — S bytes (the stream)
* per-rank ``stream[off:off+size]`` — S bytes (the blobs)
* ``crc32(bytes(blob))``            — S bytes (pre-PR ``crc32`` copied)

i.e. the state crossed memory ~4x before reaching the L1 files; the
fast path crosses once (pytree -> stream) and hands out views.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.integrity import crc32
from repro_torch.core.serialize import (
    EncodedState,
    LeafEntry,
    Manifest,
    RankEntry,
    encode_blob,
    leaf_to_np,
    split_ranks,
)
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


def encode_state_reference(
    step: int,
    state: Any,
    cluster: ClusterSpec,
    *,
    codec: str = "none",
    base: Optional[EncodedState] = None,
    rank_sizes: Optional[Sequence[int]] = None,
) -> EncodedState:
    """The seed encoder: sequential per-rank ``bytes`` slices + CRC."""
    stream, leaves = serialize_tree_reference(state)
    total = len(stream)
    parts = split_ranks(total, cluster.world_size, sizes=rank_sizes)
    base_ok = (
        base is not None
        and codec == "zstd+delta"
        and len(base.stream) == total
        and [
            (r.offset, r.raw_size) for r in base.manifest.ranks
        ] == list(parts)
    )
    blobs: List[bytes] = []
    ranks: List[RankEntry] = []
    for r, (off, size) in enumerate(parts):
        raw = stream[off : off + size]
        b = encode_blob(
            raw, codec,
            bytes(base.stream[off : off + size]) if base_ok else None,
        )
        blobs.append(bytes(b))
        ranks.append(
            RankEntry(
                rank=r, offset=off, raw_size=size, stored_size=len(b),
                crc=crc32(bytes(b)),
            )
        )
    from repro_torch.core.serialize import default_codec_impl

    man = Manifest(
        step=step,
        total_raw_bytes=total,
        codec=codec,
        base_step=base.step if base_ok else None,
        world_size=cluster.world_size,
        procs_per_node=cluster.procs_per_node,
        leaves=leaves,
        ranks=ranks,
        # whole-blob framing: chunk_size stays 0, chunks stays None; the
        # backend is still recorded so decode dispatches correctly
        codec_impl=default_codec_impl() if codec != "none" else "",
    )
    return EncodedState(step=step, stream=stream, blobs=blobs, manifest=man)
