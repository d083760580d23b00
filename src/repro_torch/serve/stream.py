"""Layer-granular streamed restore + node-local decoded-chunk cache.

Counterpart of ``repro/serve/stream.py``. A fleet replica does not need
the whole checkpoint resident before it can do useful work: it needs
the embedding and the first transformer blocks (the prefill-critical
prefix) first, then the rest in layer order. :func:`stream_restore`
plans that order from the manifest's leaf catalog alone (no data
reads), pulls each layer group through
:meth:`~repro_torch.core.engine.CheckpointManager.restore_leaves` (each
group is one aggregated, byte-balanced read plan), places the group on
the manager's device as it lands, and reports time-to-first-token (the
instant the priority prefix is resident) separately from total load
time.

``restore_leaves`` returns host tensors; without a ``sharding_fn`` each
group goes to ``manager.device`` (the card, for a manager made with
``device="cuda"``) on the calling thread's current stream, and the copy
has completed when the group is timed. A replica never serves from host
memory by default.

:class:`ChunkCache` is the node-local dedup layer for chunk-framed
codecs: co-located replicas restoring the same step (or delta steps
sharing a base) decode every chunk once per node, not once per replica.
The manager consults it through its duck-typed ``chunk_cache``
attribute, keyed ``(step, chunk row)``.
"""
from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.utils.treelib import flatten_with_names, unflatten

# Leaf-name heuristics over keystr names.  Numbered repeated blocks
# ("['block_000']['w']", "['layers_3']", "['h5']") order by their layer
# index; embedding-ish names load first and head/output-ish names last.
# Params that fit neither (e.g. a single stacked-layer leaf spanning
# every layer) form one middle group.
_BLOCK_RE = re.compile(r"\['(?:blocks?|layers?|h)[._]?(\d+)'?\]", re.IGNORECASE)
_EMBED_RE = re.compile(r"embed|wte|wpe|tok_|pos_|patch", re.IGNORECASE)
_TAIL_RE = re.compile(r"head|logits|unembed|\['out'\]|final|ln_f", re.IGNORECASE)


@dataclass(frozen=True)
class LayerGroup:
    """One streaming unit: the leaves loaded by a single read plan."""

    name: str
    leaves: Tuple[str, ...]
    nbytes: int
    priority: bool = False


def plan_layer_groups(
    entries: Iterable[Any], *, priority_blocks: int = 1
) -> List[LayerGroup]:
    """Group leaf entries into ordered layer groups.

    ``entries`` is an iterable of ``(name, size)`` pairs or objects with
    ``.name``/``.size`` (e.g. manifest :class:`LeafEntry` rows).  Order:
    embedding group, numbered block groups ascending, un-numbered middle
    group, tail (head/output) group.  The first ``1 + priority_blocks``
    groups (embedding + leading blocks, when present) are marked
    ``priority``: the TTFT prefix a streamed restore loads first.
    Every leaf lands in exactly one group.
    """
    pairs: List[Tuple[str, int]] = []
    for e in entries:
        if isinstance(e, tuple):
            pairs.append((e[0], int(e[1])))
        else:
            pairs.append((e.name, int(e.size)))

    embed: List[Tuple[str, int]] = []
    tail: List[Tuple[str, int]] = []
    mid: List[Tuple[str, int]] = []
    blocks: Dict[int, List[Tuple[str, int]]] = {}
    for name, size in pairs:
        m = _BLOCK_RE.search(name)
        if m:
            blocks.setdefault(int(m.group(1)), []).append((name, size))
        elif _EMBED_RE.search(name):
            embed.append((name, size))
        elif _TAIL_RE.search(name):
            tail.append((name, size))
        else:
            mid.append((name, size))

    def group(name: str, leaves: List[Tuple[str, int]], prio: bool) -> LayerGroup:
        return LayerGroup(
            name=name,
            leaves=tuple(n for n, _ in leaves),
            nbytes=sum(s for _, s in leaves),
            priority=prio,
        )

    out: List[LayerGroup] = []
    if embed:
        out.append(group("embed", embed, True))
    for j, idx in enumerate(sorted(blocks)):
        out.append(group(f"block_{idx:05d}", blocks[idx], j < priority_blocks))
    if mid:
        out.append(group("mid", mid, False))
    if tail:
        out.append(group("tail", tail, False))
    if out and not any(g.priority for g in out):
        # degenerate shapes (no embedding, no numbered blocks): the
        # first group is the best available prefix
        out[0] = LayerGroup(out[0].name, out[0].leaves, out[0].nbytes, True)
    return out


@dataclass
class StreamedRestore:
    """Result of :func:`stream_restore`."""

    step: int
    params: Any
    groups: List[LayerGroup]
    group_done_s: Dict[str, float]
    ttft_s: float          # priority prefix resident (time to first token)
    total_s: float         # every group resident
    priority_bytes: int
    total_bytes: int


def stream_restore(
    manager: Any,
    template: Any,
    prefix: str = "['params']",
    *,
    step: Optional[int] = None,
    priority_blocks: int = 1,
    sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    on_group: Optional[Callable[[LayerGroup, float], None]] = None,
) -> StreamedRestore:
    """Restore ``template``'s leaves layer group by layer group.

    ``template`` gives only the structure and names (its leaves may be
    on the meta device).  The step is pinned up front from
    :meth:`~repro_torch.core.engine.CheckpointManager.leaf_catalog`, so a
    newer step flushed mid-stream can never mix into the result.  Each
    group is one ``restore_leaves`` call (one aggregated read plan,
    byte-balanced across the *serving* geometry's readers), then placed
    by ``sharding_fn(name, host_tensor)`` or, without one, on
    ``manager.device``.  ``ttft_s`` is the wall-clock moment the
    priority prefix (embedding + first ``priority_blocks`` block groups)
    became resident; prefill can start there while the tail streams in.
    ``on_group(group, done_s)`` fires as each group lands.
    """
    named, treedef = flatten_with_names(template)
    names = [prefix + n for n, _ in named]
    pinned, catalog = manager.leaf_catalog(step=step, prefix=prefix)
    by_name = {e.name: e for e in catalog}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(
            f"step {pinned}: template leaves absent from checkpoint: "
            + ", ".join(missing[:4])
        )
    groups = plan_layer_groups(
        [by_name[n] for n in names], priority_blocks=priority_blocks
    )
    place = sharding_fn or (lambda _name, v: v.to(manager.device))

    vals: Dict[str, Any] = {}
    group_done: Dict[str, float] = {}
    ttft = 0.0
    t0 = time.perf_counter()
    for g in groups:
        got_step, got = manager.restore_leaves(list(g.leaves), step=pinned)
        if got_step != pinned:  # pragma: no cover - restore_leaves honors step
            raise IOError(f"stream pinned step {pinned}, read step {got_step}")
        vals.update({n: place(n, v) for n, v in got.items()})
        now = time.perf_counter() - t0
        group_done[g.name] = now
        if g.priority:
            ttft = now
        if on_group is not None:
            on_group(g, now)
    total = time.perf_counter() - t0

    return StreamedRestore(
        step=pinned,
        params=unflatten(treedef, [vals[n] for n in names]),
        groups=groups,
        group_done_s=group_done,
        ttft_s=ttft,
        total_s=total,
        priority_bytes=sum(g.nbytes for g in groups if g.priority),
        total_bytes=sum(g.nbytes for g in groups),
    )


class ChunkCache:
    """Thread-safe byte-bounded LRU of decoded chunk bytes.

    One instance per node, shared by every co-located replica (the
    manager consults it via its ``chunk_cache`` attribute).  Keys are
    ``(step, chunk row)``; values are the decoded raw bytes of one
    chunk, frozen (non-writeable) because hits are returned by
    reference to concurrent readers.  ``bytes_saved`` counts decoded
    bytes served from the cache: reads and decodes that never
    happened."""

    def __init__(self, capacity_bytes: int = 256 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._data: "OrderedDict[Any, np.ndarray]" = OrderedDict()
        self._size = 0
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0
        self._bytes_saved = 0

    def get(self, key: Any) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._data.get(key)
            if arr is None:
                self._misses += 1
                return None
            self._data.move_to_end(key)
            self._hits += 1
            self._bytes_saved += arr.nbytes
            return arr

    def put(self, key: Any, value: Any) -> None:
        arr = np.frombuffer(memoryview(value), np.uint8) if not isinstance(
            value, np.ndarray
        ) else value
        if arr.nbytes > self.capacity_bytes:
            return  # would evict everything and still not fit
        try:
            arr.flags.writeable = False  # freeze in place when we can
        except ValueError:
            arr = arr.copy()
            arr.flags.writeable = False
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._size -= old.nbytes
            self._data[key] = arr
            self._size += arr.nbytes
            self._insertions += 1
            while self._size > self.capacity_bytes and self._data:
                _, ev = self._data.popitem(last=False)
                self._size -= ev.nbytes
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._size = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "insertions": self._insertions,
                "evictions": self._evictions,
                "size_bytes": self._size,
                "entries": len(self._data),
                "bytes_saved": self._bytes_saved,
            }
