"""State (de)serialization: pytree <-> per-rank byte blobs + manifest.

VELOC semantics: each *process* checkpoints its own bytes.  On a real
multi-host deployment those are the host's addressable shards of every
array; in this single-process framework we serialize the global state to
one logical byte stream and split it into ``world_size`` contiguous
rank blobs — byte-identical reassembly, and the aggregation strategies
only ever see the per-rank sizes.

The manifest stores the leaf table (name/dtype/shape/offset) and the rank
table (offset/size/crc), so restore can:

* reassemble from any subset of levels (PFS aggregate file, per-rank
  files, node-local files),
* verify integrity per rank blob,
* **re-shard elastically**: the logical stream is mesh-agnostic, so a
  checkpoint saved from an 8-node layout restores onto 3 nodes (or onto
  other devices) unchanged.

Codecs (applied per rank blob, after splitting): ``none`` | ``zstd`` |
``zstd+delta`` (XOR against the previous checkpoint's stream, then
compress — incremental checkpointing).  Codecs change the *stored*
sizes that the flush plan sees; raw sizes are preserved in the
manifest.

Chunk framing
=============

Compression codecs are **chunk-framed**: each rank's raw segment is cut
into fixed-size chunks (``chunk_size``, last chunk ragged) and every
chunk is transformed independently, so encode/decode parallelize on the
manager's worker pool, corruption is detectable (and attributable) at
chunk granularity, and partial restore fetches only the chunks covering
the requested leaves instead of whole covering blobs.  The per-chunk
bookkeeping is the :class:`ChunkTable` — a structure-of-arrays with one
row per chunk (see its docstring for column semantics and invariants) —
persisted in the manifest as flat parallel int lists.  Under
``zstd+delta`` the transform is chunk-granular too: each chunk is
compared against the base stream's matching byte range (vectorized
``np.bitwise_xor`` / ``np.array_equal``), and *unchanged chunks store
zero bytes* — a base-reference flag — so small-update steps shrink
toward the differential-checkpointing ideal instead of re-compressing
the whole rank blob.

The seed whole-blob codecs survive as :func:`encode_blob_reference` /
:func:`decode_blob_reference` (the executable spec; also the on-disk
format of legacy manifests, which still parse and restore), selected by
``chunk_size=0``.

Compression backend: ``zstandard`` when importable, stdlib ``zlib``
otherwise (this keeps the codec matrix runnable — and benchmarked — on
machines without the optional dependency).  One compressor/decompressor
object is reused per worker thread; the backend that encoded a
checkpoint is recorded in the manifest (``codec_impl``) so decode always
uses the matching one.

A DTensor leaf (a state placed on a mesh) serializes as its whole
tensor (``utils.convert.whole_tensor``), the bytes of the same state of
plain tensors; a restore hands back plain tensors whatever the target.
"""
from __future__ import annotations

import json
import threading
import zlib as _zlib
from concurrent.futures import Executor
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.integrity import crc32
from repro_torch.kernels.checksum.ref import digest_ref
from repro_torch.utils.convert import whole_tensor
from repro_torch.utils.treelib import flatten_with_names, unflatten

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover - optional dep; zlib fallback below
    _zstd = None


@dataclass(frozen=True)
class LeafEntry:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int
    size: int


@dataclass
class RankEntry:
    rank: int
    offset: int          # offset in the logical stream
    raw_size: int
    stored_size: int
    crc: int             # crc of the *stored* blob


@dataclass(eq=False)
class Placement:
    """Columnar PFS placement: where each rank's stored blob landed.

    Parallel int64 columns, one row per write extent, sorted by
    ``(rank, src_offset)``.  This is the persisted form of a flush's
    write set: a 32k-rank manifest JSON-encodes as six flat lists
    instead of a rank-keyed dict of tuples, so manifest serialization
    no longer dominates the async flush tail at paper scale.

    * ``rank``        — producer rank whose stored blob the extent is from
    * ``file_id``     — index into ``file_names``
    * ``file_offset`` — destination byte offset inside that file
    * ``src_offset``  — offset inside the rank's stored blob
    * ``size``        — extent length (> 0)
    """

    file_names: List[str]
    rank: np.ndarray
    file_id: np.ndarray
    file_offset: np.ndarray
    src_offset: np.ndarray
    size: np.ndarray

    _COLS = ("rank", "file_id", "file_offset", "src_offset", "size")

    def __post_init__(self):
        for c in self._COLS:
            setattr(self, c, np.asarray(getattr(self, c), dtype=np.int64))
        if len({getattr(self, c).shape for c in self._COLS}) != 1:
            raise ValueError("Placement columns must have identical length")
        if len(self.rank) > 1:
            order = np.lexsort((self.src_offset, self.rank))
            for c in self._COLS:
                setattr(self, c, getattr(self, c)[order])

    def __len__(self) -> int:
        return len(self.rank)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, Placement):
            return NotImplemented
        return self.file_names == other.file_names and all(
            np.array_equal(getattr(self, c), getattr(other, c))
            for c in self._COLS
        )

    @staticmethod
    def empty() -> "Placement":
        z = np.empty(0, np.int64)
        return Placement([], z, z, z, z, z)

    def by_rank(self) -> Dict[int, List[Tuple[str, int, int, int]]]:
        """Legacy item view: rank -> [(file, file_offset, src_offset,
        size)], ordered by src_offset.  Debug/test convenience only —
        hot paths stay on the columns."""
        out: Dict[int, List[Tuple[str, int, int, int]]] = {}
        for r, f, fo, so, sz in zip(
            self.rank.tolist(), self.file_id.tolist(),
            self.file_offset.tolist(), self.src_offset.tolist(),
            self.size.tolist(),
        ):
            out.setdefault(r, []).append((self.file_names[f], fo, so, sz))
        return out

    def to_json_obj(self) -> Dict[str, Any]:
        return {
            "file_names": list(self.file_names),
            "rank": self.rank.tolist(),
            "file_id": self.file_id.tolist(),
            "file_offset": self.file_offset.tolist(),
            "src_offset": self.src_offset.tolist(),
            "size": self.size.tolist(),
        }

    @staticmethod
    def from_json_obj(obj: Any) -> "Placement":
        """Parse either the columnar form or the legacy rank-keyed dict
        ``{rank: [(file, file_offset, src_offset, size), ...]}`` written
        by pre-columnar manifests."""
        if not obj:
            return Placement.empty()
        if isinstance(obj, dict) and "rank" in obj and "file_names" in obj:
            return Placement(
                file_names=list(obj["file_names"]),
                rank=obj["rank"],
                file_id=obj["file_id"],
                file_offset=obj["file_offset"],
                src_offset=obj["src_offset"],
                size=obj["size"],
            )
        names: List[str] = []
        fid: Dict[str, int] = {}
        rank: List[int] = []
        file_id: List[int] = []
        file_offset: List[int] = []
        src_offset: List[int] = []
        size: List[int] = []
        for r, entries in obj.items():
            for fname, foff, soff, n in entries:
                j = fid.get(fname)
                if j is None:
                    j = fid[fname] = len(names)
                    names.append(fname)
                rank.append(int(r))
                file_id.append(j)
                file_offset.append(foff)
                src_offset.append(soff)
                size.append(n)
        return Placement(names, rank, file_id, file_offset, src_offset, size)


@dataclass
class Manifest:
    step: int
    total_raw_bytes: int
    codec: str
    base_step: Optional[int]          # for delta codecs
    world_size: int
    procs_per_node: int
    leaves: List[LeafEntry]
    ranks: List[RankEntry]
    precodec: str = "none"            # device-side transform (e.g. int8)
    # chunk framing of the stored blobs (compression codecs only):
    # chunk_size == 0 means whole-blob (seed/legacy) framing, chunks is
    # then None; codec_impl records the compression backend that
    # encoded this checkpoint ("zstd" | "zlib"; "" for codec none).
    codec_impl: str = ""
    chunk_size: int = 0
    chunks: Optional[ChunkTable] = None
    strategy: str = ""
    files: Dict[str, int] = field(default_factory=dict)
    # columnar file layout of every rank's stored blob on the PFS
    placement: Placement = field(default_factory=Placement.empty)
    # Flush lifecycle state (full state machine in docs/OPERATIONS.md):
    # pending -> local_done -> [flush_partial ->] flush_done, with
    # superseded/failed edges.  "flush_partial" = an in-progress or
    # interrupted flush whose placement + extent journal make it
    # resumable (CheckpointManager.resume_flushes); "superseded" = a
    # flush abandoned because a newer step replaced it; "quarantined" =
    # scrub-and-repair (repro_torch.core.repair) found some rank with *no*
    # intact copy on any level — terminal: excluded from restore,
    # steps(), delta-base selection, and reaped by GC.  restore() only
    # trusts "flush_done" PFS checkpoints — every other state falls
    # back down the level ladder.
    status: str = "pending"  # pending | local_done | flush_partial | flush_done | superseded | quarantined

    # -- read-side views ---------------------------------------------------
    #
    # "Stored space" is the concatenation of every rank's *stored*
    # (encoded) blob in rank order; "raw space" is the logical stream the
    # pytree serialized to.  With codec "none" the two coincide byte for
    # byte; with compression they differ and only whole stored blobs can
    # be decoded.  The read planner always works in stored space.

    def stored_offsets(self) -> "np.ndarray":
        """rank -> stored-space offset of its blob (len world_size + 1)."""
        from repro_torch.core.plan import stored_space_offsets

        return stored_space_offsets([r.stored_size for r in self.ranks])

    @property
    def total_stored_bytes(self) -> int:
        return sum(r.stored_size for r in self.ranks)

    def file_layout(self) -> "FileLayout":
        """Invert the persisted placement into a :class:`FileLayout`
        extent table (requires ``status == "flush_done"``).  Columnar
        placements invert with one gather — no Python loop."""
        from repro_torch.core.plan import FileLayout

        return FileLayout.from_placement(
            self.placement, [r.stored_size for r in self.ranks], self.files
        )

    def leaf_ranges(
        self, names: Sequence[str]
    ) -> List[Tuple[str, int, int]]:
        """(name, raw_offset, size) for the named leaves, in saved order.

        Raises ``KeyError`` on unknown names — partial restore must not
        silently return fewer leaves than asked for."""
        by_name = {l.name: l for l in self.leaves}
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(f"leaves not in checkpoint: {missing[:5]}")
        return [(n, by_name[n].offset, by_name[n].size) for n in names]

    def _raw_bounds(self) -> Tuple["np.ndarray", "np.ndarray"]:
        """Cached (starts, ends) of each rank's raw segment — both
        non-decreasing because ranks slice the stream contiguously."""
        cached = self.__dict__.get("_raw_bounds_cache")
        if cached is None:
            starts = np.asarray([r.offset for r in self.ranks], np.int64)
            ends = starts + np.asarray(
                [r.raw_size for r in self.ranks], np.int64
            )
            cached = self.__dict__["_raw_bounds_cache"] = (starts, ends)
        return cached

    def ranks_covering(self, raw_a: int, raw_b: int) -> List[int]:
        """Ranks whose raw segment intersects ``[raw_a, raw_b)``.

        Two ``np.searchsorted`` calls over the cached prefix arrays — a
        partial restore of thousands of leaves at paper-scale world
        sizes must not do a linear Python scan per leaf."""
        if raw_b <= raw_a:
            return []
        starts, ends = self._raw_bounds()
        lo = int(np.searchsorted(ends, raw_a, side="right"))
        hi = int(np.searchsorted(starts, raw_b, side="left"))
        return [r for r in range(lo, hi) if ends[r] > starts[r]]

    def to_json(self) -> str:
        d = {
            "step": self.step,
            "total_raw_bytes": self.total_raw_bytes,
            "codec": self.codec,
            "base_step": self.base_step,
            "world_size": self.world_size,
            "procs_per_node": self.procs_per_node,
            "leaves": [asdict(l) for l in self.leaves],
            "ranks": [asdict(r) for r in self.ranks],
            "precodec": self.precodec,
            "codec_impl": self.codec_impl,
            "chunk_size": self.chunk_size,
            "chunks": self.chunks.to_json_obj() if self.chunks is not None else None,
            "strategy": self.strategy,
            "files": self.files,
            "placement": self.placement.to_json_obj(),
            "status": self.status,
        }
        return json.dumps(d, separators=(",", ":"))

    @staticmethod
    def from_json(s: str) -> "Manifest":
        d = json.loads(s)
        d.pop("_raw_bounds_cache", None)  # legacy manifests may carry it
        d["leaves"] = [LeafEntry(name=l["name"], dtype=l["dtype"],
                                 shape=tuple(l["shape"]), offset=l["offset"],
                                 size=l["size"]) for l in d["leaves"]]
        d["ranks"] = [RankEntry(**r) for r in d["ranks"]]
        d["placement"] = Placement.from_json_obj(d.get("placement"))
        d["chunks"] = ChunkTable.from_json_obj(d.get("chunks"))
        d.setdefault("chunk_size", 0)
        # legacy (pre-chunk-framing) manifests were zstd-only
        if "codec_impl" not in d or d["codec_impl"] is None:
            d["codec_impl"] = "zstd" if d.get("codec", "none") != "none" else ""
        return Manifest(**d)


# ---------------------------------------------------------------------------
# pytree -> logical stream
# ---------------------------------------------------------------------------


# Manifest dtype string -> (torch dtype, NumPy storage dtype). The
# strings are NumPy's names, as the JAX package records them. NumPy has
# no bfloat16 of its own (the reference borrows ml_dtypes'), so bf16
# bytes move through a uint16 view.
DTYPES: Dict[str, Tuple[torch.dtype, np.dtype]] = {
    name: (tdt, np.dtype(ndt))
    for name, tdt, ndt in (
        ("bool", torch.bool, np.bool_),
        ("int8", torch.int8, np.int8),
        ("uint8", torch.uint8, np.uint8),
        ("int16", torch.int16, np.int16),
        ("uint16", torch.uint16, np.uint16),
        ("int32", torch.int32, np.int32),
        ("uint32", torch.uint32, np.uint32),
        ("int64", torch.int64, np.int64),
        ("uint64", torch.uint64, np.uint64),
        ("float16", torch.float16, np.float16),
        ("bfloat16", torch.bfloat16, np.uint16),
        ("float32", torch.float32, np.float32),
        ("float64", torch.float64, np.float64),
        ("complex64", torch.complex64, np.complex64),
        ("complex128", torch.complex128, np.complex128),
    )
}
_TORCH_NAMES = {tdt: name for name, (tdt, _) in DTYPES.items()}


def dtype_name(x: Any) -> str:
    """Manifest dtype string of a leaf: a tensor, a leaf spec with a
    torch ``dtype``, a NumPy array or a Python scalar."""
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return _TORCH_NAMES[dt]
    return str(np.asarray(x).dtype if dt is None else np.dtype(dt))


def leaf_to_np(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as a host array (C order), and its manifest dtype.
    A CUDA tensor comes to the host through one copy."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    name = _TORCH_NAMES[leaf.dtype]
    t = whole_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def leaf_from_bytes(buf: Any, dtype: str, shape: Sequence[int]) -> torch.Tensor:
    """A host tensor holding a copy of one leaf's bytes."""
    tdt, ndt = DTYPES[dtype]
    arr = np.frombuffer(buf, dtype=ndt).reshape(tuple(shape)).copy()
    t = torch.from_numpy(arr)
    return t.view(tdt) if t.dtype != tdt else t


def leaf_view(stream: torch.Tensor, entry: LeafEntry) -> torch.Tensor:
    """One leaf of a stream held in a uint8 host tensor: a dtype and
    shape view of its byte range, with no copy, where its offset is a
    multiple of its element size; a copy where it is not."""
    tdt = DTYPES[entry.dtype][0]
    b = stream[entry.offset : entry.offset + entry.size]
    if entry.offset % tdt.itemsize:
        b = b.clone()
    return b.view(tdt).view(tuple(entry.shape))


Buffer = Union[bytes, bytearray, memoryview]


def serialize_tree(
    state: Any, *, pool: Optional[Executor] = None
) -> Tuple[memoryview, List[LeafEntry]]:
    """Pytree -> one logical byte stream, written in place.

    Leaf sizes are computed first, then every leaf is copied *directly*
    into its slice of one preallocated buffer (``np.copyto`` through a
    dtype view for NumPy leaves, ``Tensor.copy_`` into a tensor view of
    the slice for torch leaves — C-order, like ``tobytes()``): one copy
    per leaf total, a CUDA leaf's D2H included, no per-leaf temporaries,
    no ``b"".join`` recopy of the whole stream.  Leaf slices are
    disjoint, so with ``pool`` the copies run concurrently (both release
    the GIL on large arrays).  Returns a read-only :class:`memoryview`;
    downstream consumers (:func:`encode_state`, CRC, L1 writes) slice it
    without copying.  The seed item-loop implementation survives as
    :func:`repro_torch.core.serialize_ref.serialize_tree_reference` and
    the equivalence tests prove the streams byte-identical.
    """
    named, _ = flatten_with_names(state)
    srcs: List[Any] = []
    leaves: List[LeafEntry] = []
    off = 0
    for name, leaf in named:
        if isinstance(leaf, torch.Tensor):
            src = whole_tensor(leaf).detach()
            size = src.numel() * src.element_size()
        else:
            src = np.asarray(leaf)
            size = int(src.nbytes)
        leaves.append(
            LeafEntry(
                name=name, dtype=dtype_name(src), shape=tuple(src.shape),
                offset=off, size=size,
            )
        )
        srcs.append(src)
        off += size
    buf = np.empty(off, np.uint8)

    def copy_leaf(job: Tuple[LeafEntry, Any]) -> None:
        entry, src = job
        if entry.size == 0:
            return
        dst = buf[entry.offset : entry.offset + entry.size]
        if isinstance(src, torch.Tensor):
            torch.from_numpy(dst).view(src.dtype).view(src.shape).copy_(src)
        else:
            np.copyto(dst.view(src.dtype).reshape(src.shape), src, casting="no")

    jobs = list(zip(leaves, srcs))
    if pool is not None and len(jobs) > 1:
        list(pool.map(copy_leaf, jobs))
    else:
        for j in jobs:
            copy_leaf(j)
    return memoryview(buf).toreadonly(), leaves


def deserialize_tree(
    stream: Union[Buffer, torch.Tensor],
    leaves: Sequence[LeafEntry],
    target: Any,
    *,
    views: bool = False,
) -> Any:
    """Fill `target`'s structure with leaf values from the stream, as
    host tensors.

    `target` may contain tensors, arrays or leaf specs; only the
    structure is used.  Leaf order must match the saved order (name
    mismatches raise).  Each leaf is a copy that owns its storage;
    with ``views``, ``stream`` is a uint8 host tensor the caller owns
    and each leaf is :func:`leaf_view` of it, so the leaves share its
    storage and writes to one reach the stream.
    """
    named, treedef = flatten_with_names(target)
    if len(named) != len(leaves):
        raise ValueError(
            f"target has {len(named)} leaves, checkpoint has {len(leaves)}"
        )
    vals = []
    for (name, _), entry in zip(named, leaves):
        if name != entry.name:
            raise ValueError(f"leaf mismatch: target {name!r} vs saved {entry.name!r}")
        if views:
            vals.append(leaf_view(stream, entry))
        else:
            buf = stream[entry.offset : entry.offset + entry.size]
            vals.append(leaf_from_bytes(buf, entry.dtype, entry.shape))
    return unflatten(treedef, vals)


# ---------------------------------------------------------------------------
# logical stream -> per-rank blobs (+ codecs)
# ---------------------------------------------------------------------------


def split_ranks(
    total: int, world_size: int, *, sizes: Optional[Sequence[int]] = None
) -> List[Tuple[int, int]]:
    """(offset, size) per rank.  Balanced contiguous split by default."""
    if sizes is not None:
        if sum(sizes) != total or len(sizes) != world_size:
            raise ValueError("explicit sizes must sum to total")
        out, off = [], 0
        for s in sizes:
            out.append((off, int(s)))
            off += int(s)
        return out
    base, rem = divmod(total, world_size)
    out, off = [], 0
    for r in range(world_size):
        s = base + (1 if r < rem else 0)
        out.append((off, s))
        off += s
    return out


def chunk_aligned_sizes(total: int, world_size: int, chunk_size: int) -> List[int]:
    """Per-rank sizes whose boundaries all fall on ``chunk_size``
    multiples of the *global* stream (last rank ragged).

    The device pre-codec chunks the whole stream in one fused launch;
    aligning the rank split to the same grid makes every per-rank chunk
    a global chunk, so the device dirty mask and digests index straight
    into each rank's :func:`encode_rank_chunks` call.  Chunks are
    spread across ranks as evenly as chunk granularity allows; ranks
    may be empty when there are fewer chunks than ranks.
    """
    if chunk_size <= 0:
        raise ValueError("chunk_aligned_sizes requires chunk_size > 0")
    n_chunks = -(-total // chunk_size) if total else 0
    per, rem = divmod(n_chunks, world_size)
    sizes, off_c = [], 0
    for r in range(world_size):
        c = per + (1 if r < rem else 0)
        a = min(off_c * chunk_size, total)
        b = min((off_c + c) * chunk_size, total)
        sizes.append(b - a)
        off_c += c
    return sizes


# -- compression backends ---------------------------------------------------
#
# One compressor/decompressor object per worker thread: the chunked
# encode/decode paths call into the backend once per chunk, and zstd
# context construction (dictionaries, window allocation) must not be
# paid inside that loop.  ``zlib`` is the stdlib fallback backend so the
# codec matrix runs (and is benchmarked) without the optional dep; the
# backend an encode actually used is recorded in the manifest
# (``codec_impl``) and decode dispatches on it.

ZSTD_LEVEL = 3
# The zlib fallback is tuned for throughput, not density: level 1 with
# the Z_RLE strategy (run-length matches + Huffman literals) compresses
# checkpoint-shaped data (zero runs of sparse optimizer moments,
# low-entropy mantissas) 1.5-2x faster than default deflate at an equal
# or better ratio, which is what the codec tier needs — it exists to cut
# PFS volume without growing the blocking window.  Output is a standard
# deflate stream; ``zlib.decompress`` is unaffected.
ZLIB_LEVEL = 1

_codec_tls = threading.local()


def default_codec_impl() -> str:
    """Backend used for new checkpoints: zstd when available, else zlib."""
    return "zstd" if _zstd is not None else "zlib"


def _zstd_c(data: Buffer, level: int = ZSTD_LEVEL) -> bytes:
    """zstd-compress with a per-thread (per-level) compressor reuse."""
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    cache = getattr(_codec_tls, "zstd_c", None)
    if cache is None:
        cache = _codec_tls.zstd_c = {}
    c = cache.get(level)
    if c is None:
        c = cache[level] = _zstd.ZstdCompressor(level=level)
    return c.compress(data)


def _zstd_d(data: Buffer, raw_size: int) -> bytes:
    """zstd-decompress with a per-thread decompressor reuse."""
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    d = getattr(_codec_tls, "zstd_d", None)
    if d is None:
        d = _codec_tls.zstd_d = _zstd.ZstdDecompressor()
    return d.decompress(data, max_output_size=max(raw_size, 1))


def compress_bytes(data: Buffer, impl: str) -> bytes:
    if impl == "zstd":
        return _zstd_c(data)
    if impl == "zlib":
        # compressobj per call: zlib contexts are a cheap malloc (unlike
        # zstd's, which get the thread-local treatment above) and expose
        # the strategy knob that plain zlib.compress hides
        co = _zlib.compressobj(ZLIB_LEVEL, _zlib.DEFLATED, 15, 8, _zlib.Z_RLE)
        return co.compress(data) + co.flush()
    raise ValueError(f"unknown codec impl {impl!r}")


def decompress_bytes(data: Buffer, raw_size: int, impl: str) -> bytes:
    if impl == "zstd":
        return _zstd_d(data, raw_size)
    if impl == "zlib":
        return _zlib.decompress(data)
    raise ValueError(f"unknown codec impl {impl!r}")


def encode_blob_reference(
    raw: Buffer, codec: str, base: Optional[Buffer] = None,
    *, impl: Optional[str] = None,
) -> Buffer:
    """Seed whole-blob encode — the executable spec of the chunked path
    (and the stored format of ``chunk_size=0`` / legacy checkpoints):
    one compressor call over the entire rank blob, delta as a
    full-stream XOR."""
    impl = impl or default_codec_impl()
    if codec == "none":
        return raw
    if codec == "zstd":
        return compress_bytes(raw, impl)
    if codec == "zstd+delta":
        if base is not None and len(base) == len(raw):
            x = np.bitwise_xor(
                np.frombuffer(raw, np.uint8), np.frombuffer(base, np.uint8)
            ).tobytes()
            return compress_bytes(x, impl)
        return compress_bytes(raw, impl)  # no base -> self-contained
    raise ValueError(f"unknown codec {codec!r}")


def decode_blob_reference(
    stored: Buffer, codec: str, raw_size: int, base: Optional[Buffer] = None,
    *, has_base: bool = False, impl: Optional[str] = None,
) -> bytes:
    """Seed whole-blob decode (inverse of :func:`encode_blob_reference`)."""
    impl = impl or default_codec_impl()
    if codec == "none":
        return stored
    if codec == "zstd":
        return decompress_bytes(stored, raw_size, impl)
    if codec == "zstd+delta":
        x = decompress_bytes(stored, raw_size, impl)
        if has_base:
            if base is None or len(base) != len(x):
                raise ValueError("delta blob requires its base blob")
            return np.bitwise_xor(
                np.frombuffer(x, np.uint8), np.frombuffer(base, np.uint8)
            ).tobytes()
        return x
    raise ValueError(f"unknown codec {codec!r}")


# ---------------------------------------------------------------------------
# Chunk-framed codecs
# ---------------------------------------------------------------------------

# Chunk flags (bitfield, one int64 per chunk):
CHUNK_COMP = 0    # stored payload = compress(raw chunk)
CHUNK_RAW = 1     # stored payload = raw chunk verbatim (incompressible)
CHUNK_BASE = 2    # no payload: chunk byte-equal to the base's range
CHUNK_DELTA = 4   # stored payload = compress(raw XOR base-range)

DEFAULT_CHUNK_SIZE = 1 << 20

# Compressibility probe: before compressing a large chunk, compress two
# small samples (head + middle); if they barely shrink, the chunk is
# high-entropy (dense fp mantissas) and is stored CHUNK_RAW without
# paying for a full compression pass that would only buy a few percent.
# Compressing incompressible tensors is where a whole-blob codec burns
# most of its blocking time on real train states (dense weights next to
# sparse optimizer moments); chunk framing is what makes the skip
# decision local and cheap.  Lossless either way — the probe only
# trades a sliver of stored ratio for encode speed.
PROBE_SAMPLE = 4096           # bytes per sample, two samples per chunk
PROBE_MIN_CHUNK = 4 * PROBE_SAMPLE   # probe only chunks worth skipping
PROBE_RATIO = 0.9             # a <10% shrink is not worth the pass


@dataclass(eq=False)
class ChunkTable:
    """Structure-of-arrays chunk framing of every rank's stored blob.

    One row per chunk, rows grouped by rank (``rank_starts[r] ..
    rank_starts[r+1]`` are rank ``r``'s rows, in chunk order).  Parallel
    int64 columns:

    * ``raw_off``    — chunk offset inside the rank's *raw* segment
    * ``raw_len``    — raw chunk length (> 0; last chunk may be ragged)
    * ``stored_off`` — payload offset inside the rank's *stored* blob
    * ``stored_len`` — payload length (0 iff ``CHUNK_BASE``)
    * ``crc``        — crc32 of the stored payload (0 iff ``CHUNK_BASE``)
    * ``flags``      — ``CHUNK_COMP`` | ``CHUNK_RAW`` | ``CHUNK_BASE`` |
      ``CHUNK_DELTA``

    ``digest`` is an optional uint64 column of per-chunk two-track
    digests of the *raw* chunk bytes (``repro_torch.kernels.checksum``
    semantics, index track restarted per chunk) — present on manifests
    encoded through the device pre-codec, where the fused pass computes
    them for free during its delta sweep.  Unlike ``crc`` (which covers
    the stored payload and is 0 for ``CHUNK_BASE`` rows), ``digest``
    covers the decoded content of *every* row, so decode can verify
    base-referenced chunks — i.e. that the resolved base stream really
    is the one the delta was taken against.

    Invariants (asserted by :meth:`validate`): per rank, ``raw`` rows
    tile ``[0, raw_size)`` exactly and ``stored`` rows tile
    ``[0, stored_size)`` exactly (base-referencing rows contribute zero
    stored bytes) — the chunk-granular restatement of the flush
    validator's source-coverage rule, which is what lets
    ``build_read_plan`` treat chunk payloads as ordinary stored-space
    extents.  ``CHUNK_BASE``/``CHUNK_DELTA`` rows may only appear in
    manifests whose ``base_step`` is set.
    """

    rank_starts: np.ndarray
    raw_off: np.ndarray
    raw_len: np.ndarray
    stored_off: np.ndarray
    stored_len: np.ndarray
    crc: np.ndarray
    flags: np.ndarray
    digest: Optional[np.ndarray] = None

    _COLS = ("raw_off", "raw_len", "stored_off", "stored_len", "crc", "flags")

    def __post_init__(self):
        self.rank_starts = np.asarray(self.rank_starts, np.int64)
        for c in self._COLS:
            setattr(self, c, np.asarray(getattr(self, c), dtype=np.int64))
        if len({getattr(self, c).shape for c in self._COLS}) != 1:
            raise ValueError("ChunkTable columns must have identical length")
        if self.digest is not None:
            self.digest = np.asarray(self.digest, dtype=np.uint64)
            if self.digest.shape != self.raw_off.shape:
                raise ValueError("ChunkTable digest column length mismatch")

    def __len__(self) -> int:
        return len(self.raw_off)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ChunkTable):
            return NotImplemented
        if (self.digest is None) != (other.digest is None) or (
            self.digest is not None
            and not np.array_equal(self.digest, other.digest)
        ):
            return False
        return np.array_equal(self.rank_starts, other.rank_starts) and all(
            np.array_equal(getattr(self, c), getattr(other, c))
            for c in self._COLS
        )

    @property
    def n_ranks(self) -> int:
        return len(self.rank_starts) - 1

    def rank_rows(self, rank: int) -> slice:
        return slice(int(self.rank_starts[rank]), int(self.rank_starts[rank + 1]))

    def covering(self, rank: int, lo: int, hi: int) -> np.ndarray:
        """Global row indices of ``rank``'s chunks intersecting the
        within-rank raw interval ``[lo, hi)`` (empty for hi <= lo)."""
        if hi <= lo:
            return np.empty(0, np.int64)
        s, e = int(self.rank_starts[rank]), int(self.rank_starts[rank + 1])
        ro = self.raw_off[s:e]
        first = int(np.searchsorted(ro, lo, side="right")) - 1
        last = int(np.searchsorted(ro, hi - 1, side="right")) - 1
        return np.arange(s + max(first, 0), s + last + 1, dtype=np.int64)

    def validate(self, ranks: Sequence["RankEntry"]) -> None:
        """Assert the tiling invariants against the manifest rank table.

        Array program over the whole table (same style as
        ``validate_plan``): boundary masks from ``rank_starts`` replace
        the per-rank Python loop, so validating a paper-scale table on
        every restore costs milliseconds, not a serial O(n_ranks) pass.
        """
        if self.n_ranks != len(ranks):
            raise ValueError("chunk table rank count mismatch")
        starts = self.rank_starts
        counts = np.diff(starts)
        if (counts < 0).any() or int(starts[0]) != 0 or int(starts[-1]) != len(self):
            raise ValueError("chunk table rank_starts malformed")
        raw_sizes = np.asarray([r.raw_size for r in ranks], np.int64)
        stored_sizes = np.asarray([r.stored_size for r in ranks], np.int64)
        nz = counts > 0
        bad = (raw_sizes > 0) != nz
        if bad.any():
            r = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"rank {r}: "
                + ("empty but has chunks" if not raw_sizes[r]
                   else "chunk raw rows do not tile raw segment")
            )
        n = len(self)
        if n == 0:
            return
        if int(self.raw_len.min()) <= 0:
            raise ValueError("non-positive raw chunk length")
        # first/last row of every non-empty rank
        f = starts[:-1][nz]
        l = starts[1:][nz] - 1
        raw_ends = self.raw_off + self.raw_len
        stored_ends = self.stored_off + self.stored_len
        # chain within ranks: every row that is not a rank's last must be
        # followed by a row starting where it ends
        is_last = np.zeros(n, bool)
        is_last[starts[1:] - 1] = True
        chain = ~is_last[:-1]
        if (
            (self.raw_off[f] != 0).any()
            or (raw_ends[l] != raw_sizes[nz]).any()
            or (chain & (self.raw_off[1:] != raw_ends[:-1])).any()
        ):
            raise ValueError("chunk raw rows do not tile the raw segments")
        if (
            (self.stored_off[f] != 0).any()
            or (stored_ends[l] != stored_sizes[nz]).any()
            or (chain & (self.stored_off[1:] != stored_ends[:-1])).any()
        ):
            raise ValueError("chunk stored rows do not tile the stored blobs")
        base_rows = (self.flags & CHUNK_BASE) != 0
        if (self.stored_len[base_rows] != 0).any() or (
            self.stored_len[~base_rows] <= 0
        ).any():
            raise ValueError("stored_len inconsistent with flags")

    @staticmethod
    def from_rank_lists(per_rank: Sequence[Tuple[List[int], ...]]) -> "ChunkTable":
        """Assemble from per-rank column lists (encode's output), in
        rank order.  Each element is (raw_off, raw_len, stored_off,
        stored_len, crc, flags) lists for that rank."""
        counts = [len(p[0]) for p in per_rank]
        starts = np.zeros(len(per_rank) + 1, np.int64)
        np.cumsum(np.asarray(counts, np.int64), out=starts[1:])
        cols = [
            np.asarray([v for p in per_rank for v in p[i]], np.int64)
            for i in range(6)
        ]
        return ChunkTable(starts, *cols)

    def to_json_obj(self) -> Dict[str, Any]:
        obj = {
            "rank_starts": self.rank_starts.tolist(),
            **{c: getattr(self, c).tolist() for c in self._COLS},
        }
        if self.digest is not None:
            obj["digest"] = [int(d) for d in self.digest]
        return obj

    @staticmethod
    def from_json_obj(obj: Any) -> Optional["ChunkTable"]:
        if not obj:
            return None
        return ChunkTable(
            rank_starts=obj["rank_starts"],
            **{c: obj[c] for c in ChunkTable._COLS},
            digest=obj.get("digest"),
        )


def encode_rank_chunks(
    raw: Buffer,
    base: Optional[Buffer],
    codec: str,
    chunk_size: int,
    impl: str,
    *,
    dirty: Optional[Sequence[bool]] = None,
    deltas: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> Tuple[Buffer, Tuple[List[int], ...]]:
    """Chunk-frame one rank's raw segment into its stored blob.

    Every ``chunk_size`` slice is transformed independently: compressed
    (``CHUNK_COMP``), stored raw when compression does not pay
    (``CHUNK_RAW``), or — under delta with a base — XOR-compressed
    against the base's matching range (``CHUNK_DELTA``) or elided
    entirely when byte-equal to it (``CHUNK_BASE``, zero stored bytes).
    The dirty-chunk comparison and the XOR are vectorized over the
    chunk's uint8 views; nothing here copies the raw stream beyond the
    one XOR scratch per dirty chunk.

    Staged mode (device pre-codec): when ``dirty`` is given, the
    per-chunk ``np.array_equal`` scan and the host XOR are skipped —
    the fused device pass already decided cleanliness and produced the
    XOR payloads.  ``dirty[i]`` is the within-rank chunk's dirtiness
    and ``deltas[i]`` its precomputed XOR bytes (``None`` for clean
    chunks); ``base`` is not consulted.  The probe/compress/flag logic
    is byte-identical to the host path, so staged and host encodes of
    the same rank segment produce the same stored blob.

    Returns the assembled stored blob plus the per-chunk column lists
    for :meth:`ChunkTable.from_rank_lists`.
    """
    n = len(raw)
    cols: Tuple[List[int], ...] = ([], [], [], [], [], [])
    raw_off, raw_len, stored_off, stored_len, crcs, flags = cols
    if n == 0:
        return b"", cols
    rv = np.frombuffer(raw, np.uint8)
    staged = dirty is not None
    bv = (
        np.frombuffer(base, np.uint8)
        if (
            not staged
            and codec == "zstd+delta"
            and base is not None
            and len(base) == n
        )
        else None
    )

    def probably_incompressible(data: np.ndarray) -> bool:
        ln = len(data)
        if ln < PROBE_MIN_CHUNK:
            return False               # small chunks: just compress them
        mid = (ln // 2) & ~7
        sample = np.concatenate(
            (data[:PROBE_SAMPLE], data[mid : mid + PROBE_SAMPLE])
        )
        # the probe is a heuristic signal, not the stored format, so it
        # always uses the one-call stdlib compressor: per-sample
        # compressobj construction would cost more than the sample
        return len(_zlib.compress(sample, 1)) >= PROBE_RATIO * len(sample)

    out = bytearray()
    for ci, off in enumerate(range(0, n, chunk_size)):
        ln = min(chunk_size, n - off)
        rc = rv[off : off + ln]
        # CHUNK_RAW payloads append the chunk view directly (one copy,
        # hashed in place) — raw-heavy blobs must not pay a tobytes
        # round trip per chunk on top of the bytearray append.
        payload: Optional[bytes] = None
        if staged or bv is not None:
            if staged:
                clean = not dirty[ci]
                x = None if clean else deltas[ci]
            else:
                bc = bv[off : off + ln]
                clean = np.array_equal(rc, bc)
                x = None if clean else np.bitwise_xor(rc, bc)
            if clean:
                payload, flag = b"", CHUNK_BASE
            elif probably_incompressible(x):
                flag = CHUNK_RAW
            else:
                comp = compress_bytes(x, impl)
                if len(comp) < ln:
                    payload, flag = comp, CHUNK_DELTA
                else:  # XOR didn't pay: store the raw chunk, self-contained
                    flag = CHUNK_RAW
        elif probably_incompressible(rc):
            flag = CHUNK_RAW
        else:
            comp = compress_bytes(rc, impl)
            if len(comp) < ln:
                payload, flag = comp, CHUNK_COMP
            else:
                flag = CHUNK_RAW
        raw_off.append(off)
        raw_len.append(ln)
        stored_off.append(len(out))
        if flag == CHUNK_RAW:
            stored_len.append(ln)
            crcs.append(crc32(rc))
            out += memoryview(rc)
        else:
            stored_len.append(len(payload))
            crcs.append(crc32(payload) if payload else 0)
            out += payload
        flags.append(flag)
    # hand back the bytearray itself: crc32, the L1 sink and the flush
    # path all take arbitrary buffers, and a bytes() here would recopy
    # nearly the whole state (raw-heavy blobs) inside the blocking window
    return out, cols


def decode_chunk_into(
    dst: np.ndarray,
    payload: Buffer,
    flag: int,
    crc: int,
    raw_len: int,
    base_seg: Optional[Buffer],
    impl: str,
    *,
    verify: bool = True,
    digest: Optional[int] = None,
    what: str = "chunk",
) -> None:
    """Decode one chunk directly into its slice of the output stream.

    ``dst`` is the preallocated uint8 view of the chunk's raw range —
    no ``b"".join``, no per-chunk output ``bytes``; the only temporary
    is the decompressor's output for compressed chunks.  ``verify``
    checks the chunk's stored-payload CRC first, so corruption is
    attributed to a single chunk even on sub-blob (partial-restore)
    reads where no whole-blob CRC exists.

    ``digest``, when given (manifests with a :class:`ChunkTable`
    ``digest`` column), is checked against the *decoded* raw bytes —
    this also covers ``CHUNK_BASE``/``CHUNK_DELTA`` rows, whose
    correctness otherwise depends on resolving the right base stream.
    """
    if flag & CHUNK_BASE:
        if base_seg is None or len(base_seg) != raw_len:
            raise IOError(f"{what}: base-referencing chunk without its base")
        np.copyto(dst, np.frombuffer(base_seg, np.uint8))
    elif verify and crc32(payload) != crc:
        raise IOError(f"{what}: chunk checksum mismatch")
    elif flag & CHUNK_RAW:
        if len(payload) != raw_len:
            raise IOError(f"{what}: raw chunk length mismatch")
        np.copyto(dst, np.frombuffer(payload, np.uint8))
    else:
        x = decompress_bytes(payload, raw_len, impl)
        if len(x) != raw_len:
            raise IOError(
                f"{what}: chunk decompressed to {len(x)} of {raw_len} bytes"
            )
        xv = np.frombuffer(x, np.uint8)
        if flag & CHUNK_DELTA:
            if base_seg is None or len(base_seg) != raw_len:
                raise IOError(f"{what}: delta chunk without its base")
            np.bitwise_xor(xv, np.frombuffer(base_seg, np.uint8), out=dst)
        else:
            np.copyto(dst, xv)
    if digest is not None and _raw_chunk_digest(dst) != digest:
        raise IOError(f"{what}: raw chunk digest mismatch")


def _raw_chunk_digest(dst: np.ndarray) -> int:
    """Two-track digest of a decoded chunk's raw bytes (zero-padded to
    a word boundary) — the host oracle for the fused pass's per-chunk
    checksum output."""
    n = dst.size
    rem = (-n) % 4
    if rem:
        w = np.zeros(n + rem, np.uint8)
        w[:n] = dst
    else:
        w = dst
    return digest_ref(w.view(np.uint32))


@dataclass
class EncodedState:
    """One checkpoint, serialized + split + encoded, ready to plan/flush.

    Buffer ownership: with codec ``none`` every entry of ``blobs`` is a
    read-only :class:`memoryview` slice of ``stream`` — the pytree's
    bytes exist exactly once between serialization and the L1 files.
    Compression codecs materialize per-rank ``bytes`` (unavoidably: the
    stored bytes differ from the raw ones).  ``stream`` is kept alive by
    the L0 twin and by delta bases; the views never outlive it.
    """

    step: int
    stream: Buffer                  # raw logical stream (kept for L0/delta)
    blobs: List[Buffer]             # stored (encoded) blob per rank
    manifest: Manifest


def _run_grouped(pool: Optional[Executor], fn, jobs: List, groups: int = 128):
    """Run ``fn`` over ``jobs`` on ``pool``, batched into at most
    ``groups`` tasks (order-preserving).

    At paper scale a save/restore has thousands of per-rank/per-chunk
    work items, each only ~a millisecond; submitting them individually
    spends more time in future bookkeeping and GIL hand-offs than in
    the work.  ~128 groups keeps the pool saturated (work stealing
    still balances stragglers) at 1/8th the scheduling traffic.
    """
    if pool is None or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    size = max(1, -(-len(jobs) // groups))
    batches = [jobs[i : i + size] for i in range(0, len(jobs), size)]
    out: List = []
    for chunk in pool.map(lambda b: [fn(j) for j in b], batches):
        out.extend(chunk)
    return out


def encode_state(
    step: int,
    state: Any,
    cluster: ClusterSpec,
    *,
    codec: str = "none",
    base: Optional[EncodedState] = None,
    rank_sizes: Optional[Sequence[int]] = None,
    chunk_aligned: bool = False,
    pool: Optional[Executor] = None,
    rank_sink: Optional[Any] = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> EncodedState:
    """Serialize + split + encode one checkpoint.

    ``chunk_aligned=True`` derives ``rank_sizes`` from
    :func:`chunk_aligned_sizes`, so rank boundaries land on the global
    ``chunk_size`` grid — the same split :func:`encode_state_staged`
    uses, which makes host and device-staged encodings of the same
    state byte-comparable (no per-rank tail chunks).

    Zero-copy contract: rank blobs are memoryview slices of the stream
    (codec ``none`` stores them as-is — zero extra copies between the
    pytree and the L1 files), and :func:`~repro_torch.core.integrity.crc32`
    hashes the views in place.

    Compression codecs are chunk-framed (see the module doc): each
    rank's task cuts its raw segment into ``chunk_size`` chunks and
    transforms them with the per-thread compressor, so at any world
    size above one, chunks compress in parallel across the pool's
    workers.  ``chunk_size=0`` selects the seed whole-blob framing
    (:func:`encode_blob_reference`) — the format of legacy checkpoints.

    ``pool`` runs the per-rank work concurrently; ``rank_sink(rank,
    blob)``, when given, is called inside each rank's task right after
    its CRC — the engine injects the L1 write here, so encode + CRC +
    node-local drain are **one fused parallel phase**: CRC (holding the
    GIL) of one rank overlaps the file write (GIL released) of another
    instead of running as two barriers.
    """
    stream, leaves = serialize_tree(state, pool=pool)
    total = len(stream)
    if chunk_aligned and rank_sizes is None and chunk_size > 0:
        rank_sizes = chunk_aligned_sizes(total, cluster.world_size, chunk_size)
    parts = split_ranks(total, cluster.world_size, sizes=rank_sizes)
    base_ok = (
        base is not None
        and codec == "zstd+delta"
        and len(base.stream) == total
        and [
            (r.offset, r.raw_size) for r in base.manifest.ranks
        ] == list(parts)
    )
    chunked = codec != "none" and chunk_size > 0
    impl = default_codec_impl() if codec != "none" else ""

    def encode_rank(job: Tuple[int, int, int]):
        r, off, size = job
        raw = stream[off : off + size]
        base_seg = base.stream[off : off + size] if base_ok else None
        if chunked:
            b, cols = encode_rank_chunks(raw, base_seg, codec, chunk_size, impl)
        else:
            b, cols = encode_blob_reference(raw, codec, base_seg, impl=impl), None
        entry = RankEntry(
            rank=r, offset=off, raw_size=size, stored_size=len(b),
            crc=crc32(b),
        )
        if rank_sink is not None:
            rank_sink(r, b)
        return b, entry, cols

    jobs = [(r, off, size) for r, (off, size) in enumerate(parts)]
    results = _run_grouped(pool, encode_rank, jobs)
    blobs = [b for b, _, _ in results]
    ranks = [e for _, e, _ in results]
    man = Manifest(
        step=step,
        total_raw_bytes=total,
        codec=codec,
        base_step=base.step if base_ok else None,
        world_size=cluster.world_size,
        procs_per_node=cluster.procs_per_node,
        leaves=leaves,
        ranks=ranks,
        codec_impl=impl,
        chunk_size=chunk_size if chunked else 0,
        chunks=(
            ChunkTable.from_rank_lists([c for _, _, c in results])
            if chunked
            else None
        ),
    )
    return EncodedState(step=step, stream=stream, blobs=blobs, manifest=man)


def encode_state_staged(
    step: int,
    cluster: ClusterSpec,
    *,
    stream: Buffer,
    leaves: List[LeafEntry],
    chunk_size: int,
    base_step: Optional[int],
    dirty: Optional[np.ndarray],
    deltas: Optional[Dict[int, np.ndarray]],
    digests: np.ndarray,
    pool: Optional[Executor] = None,
    rank_sink: Optional[Any] = None,
) -> EncodedState:
    """Encode a checkpoint from device pre-codec staging buffers.

    The staged twin of :func:`encode_state` for ``zstd+delta``: the
    pytree was already serialized on device (``stream`` is the staged
    host copy, ``leaves`` its table) and the fused pass already chunked
    it — ``dirty`` is the global per-chunk mask, ``deltas`` maps dirty
    global chunk indices to their XOR payloads, and ``digests`` the
    per-chunk raw digests that become the manifest's digest column.

    The rank split is :func:`chunk_aligned_sizes`, so global chunk
    ``i`` is exactly within-rank chunk ``i - off // chunk_size`` of its
    owner and the mask/payloads slice straight into each rank's
    :func:`encode_rank_chunks` call.  With ``base_step=None`` (anchor
    saves, or a device base miss) each rank encodes through the plain
    no-base host path — the stored blobs stay byte-identical to a host
    ``encode_state`` of the same stream over the same split.
    """
    total = len(stream)
    n_chunks = -(-total // chunk_size) if total else 0
    digests = np.asarray(digests, np.uint64)
    if len(digests) != n_chunks:
        raise ValueError(
            f"staged digests cover {len(digests)} chunks, stream has {n_chunks}"
        )
    delta_mode = base_step is not None
    if delta_mode and (dirty is None or len(dirty) != n_chunks):
        raise ValueError("staged delta encode requires a full dirty mask")
    parts = split_ranks(
        total, cluster.world_size,
        sizes=chunk_aligned_sizes(total, cluster.world_size, chunk_size),
    )
    impl = default_codec_impl()

    def encode_rank(job: Tuple[int, int, int]):
        r, off, size = job
        raw = stream[off : off + size]
        if delta_mode and size:
            c0 = off // chunk_size
            nc = -(-size // chunk_size)
            d = dirty[c0 : c0 + nc]
            x = [deltas[c0 + i] if d[i] else None for i in range(nc)]
            b, cols = encode_rank_chunks(
                raw, None, "zstd+delta", chunk_size, impl, dirty=d, deltas=x
            )
        else:
            b, cols = encode_rank_chunks(raw, None, "zstd+delta", chunk_size, impl)
        entry = RankEntry(
            rank=r, offset=off, raw_size=size, stored_size=len(b),
            crc=crc32(b),
        )
        if rank_sink is not None:
            rank_sink(r, b)
        return b, entry, cols

    jobs = [(r, off, size) for r, (off, size) in enumerate(parts)]
    results = _run_grouped(pool, encode_rank, jobs)
    table = ChunkTable.from_rank_lists([c for _, _, c in results])
    table.digest = digests
    man = Manifest(
        step=step,
        total_raw_bytes=total,
        codec="zstd+delta",
        base_step=base_step,
        world_size=cluster.world_size,
        procs_per_node=cluster.procs_per_node,
        leaves=leaves,
        ranks=[e for _, e, _ in results],
        codec_impl=impl,
        chunk_size=chunk_size,
        chunks=table,
    )
    return EncodedState(
        step=step, stream=stream, blobs=[b for b, _, _ in results], manifest=man
    )


def decode_stream(
    manifest: Manifest,
    blobs: Sequence[Buffer],
    *,
    base_stream: Optional[Buffer] = None,
    verify: bool = True,
    pool: Optional[Executor] = None,
    out: Optional[np.ndarray] = None,
) -> memoryview:
    """Rank blobs -> the raw logical stream, written in place.

    The decode twin of the zero-copy encode: one ``uint8`` output
    buffer is preallocated and every chunk (chunk-framed manifests) or
    rank blob (codec ``none`` / legacy whole-blob manifests)
    decompresses/copies *directly into its slice* — no ``b"".join``, no
    per-chunk ``bytes`` churn.  Slices are disjoint, so with ``pool``
    the work runs concurrently (decompression and ``np.copyto`` release
    the GIL).  ``out``, a writable contiguous ``uint8`` array of
    ``total_raw_bytes``, is that buffer where the caller gives one.

    Integrity: chunk-framed manifests verify the per-chunk CRCs inside
    the (pooled) chunk tasks — same coverage as the rank CRC, since
    chunk payloads tile the stored blob, but parallel and attributable
    to a single chunk.  Whole-blob manifests verify per-rank CRCs, also
    on the pool.  Callers that already verified arrival CRCs pass
    ``verify=False``.
    """
    has_base = manifest.base_step is not None
    if out is None:
        out = np.empty(manifest.total_raw_bytes, np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (manifest.total_raw_bytes,)
          or not out.flags.writeable or not out.flags.c_contiguous):
        raise ValueError(
            f"decode destination must be a writable contiguous uint8 array of "
            f"{manifest.total_raw_bytes} bytes"
        )
    if len(blobs) != len(manifest.ranks):
        raise IOError("blob count does not match the manifest rank table")

    def run(fn, jobs) -> None:
        _run_grouped(pool, fn, jobs)

    table = manifest.chunks
    if manifest.codec == "none" or table is None:
        # codec none + legacy whole-blob manifests: per-rank decode.
        def decode_rank(i: int) -> None:
            entry, blob = manifest.ranks[i], blobs[i]
            if verify and crc32(blob) != entry.crc:
                raise IOError(f"rank {entry.rank}: checksum mismatch")
            base = (
                base_stream[entry.offset : entry.offset + entry.raw_size]
                if (base_stream is not None and has_base)
                else None
            )
            raw = decode_blob_reference(
                blob, manifest.codec, entry.raw_size, base,
                has_base=has_base, impl=manifest.codec_impl or None,
            )
            if len(raw) != entry.raw_size:
                raise IOError(f"rank {entry.rank}: decoded to wrong size")
            dst = out[entry.offset : entry.offset + entry.raw_size]
            np.copyto(dst, np.frombuffer(raw, np.uint8))

        run(decode_rank, list(range(len(blobs))))
    else:
        table.validate(manifest.ranks)
        impl = manifest.codec_impl or default_codec_impl()
        rank_of = np.repeat(
            np.arange(table.n_ranks, dtype=np.int64), np.diff(table.rank_starts)
        )
        # memoryviews once per blob: slicing bytes/bytearray copies,
        # slicing a view does not — chunk payloads stay zero-copy
        views = [memoryview(b) for b in blobs]

        def decode_chunk(row: int) -> None:
            r = int(rank_of[row])
            entry = manifest.ranks[r]
            ro = int(table.raw_off[row])
            rl = int(table.raw_len[row])
            so = int(table.stored_off[row])
            sl = int(table.stored_len[row])
            flag = int(table.flags[row])
            g = entry.offset + ro
            base_seg = (
                base_stream[g : g + rl]
                if (base_stream is not None and (flag & (CHUNK_BASE | CHUNK_DELTA)))
                else None
            )
            decode_chunk_into(
                out[g : g + rl], views[r][so : so + sl], flag,
                int(table.crc[row]), rl, base_seg, impl,
                verify=verify,
                digest=(
                    int(table.digest[row])
                    if (verify and table.digest is not None)
                    else None
                ),
                what=f"rank {r} chunk {row - int(table.rank_starts[r])}",
            )

        run(decode_chunk, list(range(len(table))))
    return memoryview(out)


def decode_state(
    manifest: Manifest,
    blobs: Sequence[Buffer],
    target: Any,
    *,
    base_stream: Optional[Buffer] = None,
    verify: bool = True,
    pool: Optional[Executor] = None,
    into: Optional[torch.Tensor] = None,
) -> Any:
    """Rank blobs -> ``target``'s structure of host tensors.

    Without ``into`` the stream is :func:`decode_stream`'s own buffer
    and every leaf a copy of its bytes.  ``into``, a uint8 host tensor
    of ``total_raw_bytes`` that the caller owns, is where the chunks
    decode, and the leaves come back as views of it
    (:func:`deserialize_tree` ``views``): each byte is written once.
    """
    stream = decode_stream(
        manifest, blobs, base_stream=base_stream, verify=verify, pool=pool,
        out=None if into is None else into.numpy(),
    )
    if len(stream) != manifest.total_raw_bytes:
        raise IOError("reassembled stream has wrong size")
    if into is not None:
        return deserialize_tree(into, manifest.leaves, target, views=True)
    return deserialize_tree(stream, manifest.leaves, target)
