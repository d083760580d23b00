"""Device-side pre-codecs applied to the state *before* serialization.

Counterpart of ``repro/core/precodec.py``, on torch tensors.

``int8`` — blockwise int8 quantization (:mod:`repro_torch.kernels.quantize`):
every float leaf of at least ``MIN_QUANT_ELEMS`` values is replaced by
``{"q": int8 blocks, "s": f32 scales}`` computed on the device, shrinking
flush volume ~4x (bf16: ~2x).  Lossy — intended for high-frequency
checkpoint tiers where PFS pressure dominates, with periodic lossless
checkpoints alongside.

Transform + inverse are structure-deterministic so saved and restoring
processes independently agree on the manifest leaf table.

Device-resident staging (:class:`DevicePrecodec`): instead of the
per-leaf ``quantize_tree`` map + full-state D2H + host-side dirty scan,
the whole transformed state is assembled into one word stream *on the
device* (one grouped quantize launch for every float leaf together),
the fused CUDA pass (:mod:`repro_torch.kernels.fused`) XORs it against
the previous staged snapshot and emits the per-chunk dirty mask +
digests, and only the dirty chunks are copied D2H — asynchronously,
overlapped with the caller's next train step.  ``save()`` then consumes
the staged buffers (see ``engine.CheckpointConfig.device_precodec``);
the per-leaf host path stays as the executable reference spec the
staged stream is asserted byte-identical against.

Unlike the JAX package, 64-bit leaves are accepted on the device path:
torch never narrows them. A DTensor leaf (a state placed on a mesh) is
read as its whole tensor (``utils.convert.whole_tensor``: its local
tensor on a mesh of one device), so it stages the bytes of the same
state of plain tensors.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.serialize import DTYPES, Buffer, LeafEntry, dtype_name
from repro_torch.kernels.common import pad_to_multiple, resolve_device
from repro_torch.kernels.fused.ops import (
    CHUNK_ALIGN,
    digests_from_meta,
    dirty_from_meta,
    fused_precodec,
    meta_to_numpy,
)
from repro_torch.kernels.quantize.ops import (
    BLOCK,
    TILE,
    dequantize,
    quantize,
    quantize_blocks_needed,
)
from repro_torch.utils.convert import whole_tensor
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, tree_map, unflatten

_FLOATS = {"float32", "float64", "bfloat16", "float16"}
# leaves smaller than one kernel tile stay raw: the 4096-value tile pad
# would inflate them, and tiny tensors (norm scales, biases) are exactly
# where int8 noise hurts most.
MIN_QUANT_ELEMS = 4096


@dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of a leaf without its data (what
    ``jax.ShapeDtypeStruct`` is to the JAX package)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _numel(x: Any) -> int:
    shape = tuple(getattr(x, "shape", np.shape(x)))
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _is_float_leaf(x: Any) -> bool:
    try:
        if dtype_name(x) not in _FLOATS:
            return False
    except (TypeError, KeyError):
        return False
    return _numel(x) >= MIN_QUANT_ELEMS


def _as_tensor(x: Any) -> torch.Tensor:
    return whole_tensor(x) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def quantize_tree(state: Any) -> Any:
    def f(leaf):
        if not _is_float_leaf(leaf):
            return leaf
        q, s = quantize(_as_tensor(leaf))
        return {"q": q, "s": s}

    return tree_map(f, state)


def quant_target_like(target: Any) -> Any:
    """The structure ``quantize_tree`` would produce, as LeafSpecs."""

    def f(leaf):
        if not _is_float_leaf(leaf):
            return leaf
        blocks = quantize_blocks_needed(_numel(leaf))
        return {
            "q": LeafSpec((blocks, BLOCK), torch.int8),
            "s": LeafSpec((blocks,), torch.float32),
        }

    return tree_map(f, target)


def _host_np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dequantize_leaf(q: Any, s: Any, t: Any) -> torch.Tensor:
    """Vectorized host-side dequant of one leaf: ``q * s`` per block,
    one f32 multiply per element, then cast to ``t``'s dtype (bf16 and
    f16 round to nearest even, as NumPy's ``astype`` does)."""
    n = _numel(t)
    x = _host_np(q).astype(np.float32) * _host_np(s).astype(np.float32)[:, None]
    shape = tuple(getattr(t, "shape", np.shape(t)))
    out = torch.from_numpy(x.reshape(-1)[:n].reshape(shape))
    return out.to(DTYPES[dtype_name(t)][0])


def _is_qleaf(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def dequantize_tree(qtree: Any, target: Any, *, pool: Any = None) -> Any:
    """Invert ``quantize_tree`` into ``target``'s shapes/dtypes, as host
    tensors.

    Vectorized per leaf and — given ``pool`` — parallel across leaves:
    the block multiplies and casts release the GIL. The per-leaf kernel
    loop survives as :func:`dequantize_tree_reference`, the executable
    spec this path is tested bit-identical against.
    """
    named, tdef = flatten_with_names(target)
    tleaves = [leaf for _, leaf in named]
    qleaves = tree_leaves(qtree, is_leaf=_is_qleaf)
    if len(tleaves) != len(qleaves):
        raise ValueError("quantized tree does not match target structure")

    def one(job):
        t, q = job
        if isinstance(q, dict):
            return _dequantize_leaf(q["q"], q["s"], t)
        return q

    jobs = list(zip(tleaves, qleaves))
    if pool is not None and len(jobs) > 1:
        out = list(pool.map(one, jobs))
    else:
        out = [one(j) for j in jobs]
    return unflatten(tdef, out)


def dequantize_tree_reference(qtree: Any, target: Any, *, device: Any = "cuda") -> Any:
    """Per-leaf kernel restore: one ``dequantize`` launch per quantized
    leaf on ``device``, then a reshape and a cast to the target leaf's
    dtype (bf16 and f16 round to nearest even). Leaves that were not
    quantized come back as they are. Kept as the executable spec for
    :func:`dequantize_tree`."""
    dev = resolve_device(device)
    named, tdef = flatten_with_names(target)
    tleaves = [leaf for _, leaf in named]
    qleaves = tree_leaves(qtree, is_leaf=_is_qleaf)
    if len(tleaves) != len(qleaves):
        raise ValueError("quantized tree does not match target structure")
    out = []
    for t, q in zip(tleaves, qleaves):
        if isinstance(q, dict):
            x = dequantize(
                _as_tensor(q["q"]).to(dev), _as_tensor(q["s"]).to(dev), n=_numel(t)
            )
            shape = tuple(getattr(t, "shape", np.shape(t)))
            out.append(x.reshape(shape).to(DTYPES[dtype_name(t)][0]))
        else:
            out.append(q)
    return unflatten(tdef, out)


# -- device-resident pre-codec staging --------------------------------------


def _leaf_bytes(x: torch.Tensor) -> torch.Tensor:
    """Flat little-endian uint8 view of a tensor — the device twin of
    ``np.asarray(leaf).tobytes()`` (C order)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


@dataclass
class _StreamSpec:
    """Per-(treedef, shapes, precodec) device serializer."""

    fn: Any                    # ordered leaf list -> int32 word stream
    leaves: List[LeafEntry]    # transformed leaf table (manifest layout)
    total: int                 # serialized byte count


@dataclass
class _StageResult:
    base_step: Optional[int]   # base actually used (None: full snapshot)
    mask: np.ndarray           # (n_chunks,) bool dirty mask
    digests: np.ndarray        # (n_chunks,) uint64 raw-chunk digests
    dirty_idx: np.ndarray      # global indices of dirty chunks
    host: torch.Tensor         # (n_dirty, chunk_words) int32 on the host
    done: Optional[torch.cuda.Event]  # D2H into ``host`` complete
    stage_s: float


@dataclass
class StagedPrecodec:
    """Handle for one in-flight staged step (returned by ``stage``)."""

    step: int
    base_step: Optional[int]   # the *requested* base (device may still miss)
    spec: _StreamSpec
    future: "Future[_StageResult]"


@dataclass
class StagedBuffers:
    """Host-side staging output, ready for ``encode_state_staged``."""

    stream: memoryview         # reconstructed raw logical stream
    leaves: List[LeafEntry]
    mask: np.ndarray           # (n_chunks,) bool
    deltas: Dict[int, np.ndarray]  # dirty global chunk -> u8 XOR payload
    digests: np.ndarray        # (n_chunks,) uint64
    base_step: Optional[int]
    stage_s: float             # device-side work (worker thread span)
    wait_s: float              # how long consume() blocked on the D2H


class DevicePrecodec:
    """Double-buffered device→host checkpoint staging.

    ``stage(step, state)`` enqueues one device pass that assembles the
    transformed state into a word stream (grouped quantize launch — one
    launch for *all* float leaves) on the caller's current CUDA stream,
    then hands the rest to a single background worker: on its own side
    stream (which waits on an event recorded after the assembly) the
    fused kernel diffs the stream against the device-held words of the
    previously staged step, and only the dirty chunks (``index_select``
    on the int32 words) start an async D2H copy into pinned host
    memory.  The caller's next train step runs concurrently, and may
    update the state in place on its stream; ``consume`` (called from
    ``save()``) blocks only on whatever D2H is still in flight, then
    reconstructs the raw stream host-side as ``base XOR delta`` over the
    dirty chunks.

    Buffer ownership: the worker owns the device word stream of the
    last staged step (the double buffer — it becomes the next step's
    base and is replaced, never mutated); the host never holds a full
    D2H copy of a delta step, only its dirty chunks plus the previous
    stream already resident in the engine's L0 twin.

    On a CPU device the same steps run synchronously with the kernels'
    plain versions.
    """

    def __init__(
        self,
        *,
        chunk_size: int,
        precodec: str = "none",
        device: Any = "cuda",
    ):
        if chunk_size <= 0 or chunk_size % CHUNK_ALIGN:
            raise ValueError(
                f"device precodec requires chunk_size to be a positive "
                f"multiple of {CHUNK_ALIGN}, got {chunk_size}"
            )
        if precodec not in ("none", "int8"):
            raise ValueError(f"unknown precodec {precodec!r}")
        self.chunk_size = chunk_size
        self.precodec = precodec
        self.device = torch.device(device)
        self._side = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._specs: Dict[Any, _StreamSpec] = {}
        self._lock = threading.Lock()
        self._exec = ThreadPoolExecutor(1, thread_name_prefix="precodec-stage")
        self._base_words: Optional[torch.Tensor] = None
        self._base_step: Optional[int] = None

    # -- spec construction --------------------------------------------------

    def _spec_for(self, named, treedef) -> _StreamSpec:
        key = (
            treedef,
            tuple(
                (tuple(getattr(l, "shape", np.shape(l))), dtype_name(l))
                for _, l in named
            ),
            self.precodec,
        )
        with self._lock:
            spec = self._specs.get(key)
        if spec is not None:
            return spec
        spec = self._build_spec(named, treedef)
        with self._lock:
            self._specs[key] = spec
        return spec

    def _build_spec(self, named, treedef) -> _StreamSpec:
        quant_rows: List[Optional[Tuple[int, int]]] = []
        rows = 0
        for _, leaf in named:
            if self.precodec == "int8" and _is_float_leaf(leaf):
                r = quantize_blocks_needed(_numel(leaf))
                quant_rows.append((rows, rows + r))
                rows += r
            else:
                quant_rows.append(None)
        device = self.device

        def build(leaf_list):
            xs = [_as_tensor(leaf).to(device) for leaf in leaf_list]
            qparts = [
                pad_to_multiple(x.reshape(-1).to(torch.float32), TILE)
                for x, qr in zip(xs, quant_rows)
                if qr is not None
            ]
            if qparts:
                q, s = quantize(torch.cat(qparts))
            parts = []
            for x, qr in zip(xs, quant_rows):
                if qr is None:
                    parts.append(_leaf_bytes(x))
                else:
                    a, b = qr
                    parts.append(_leaf_bytes(q[a:b]))
                    parts.append(_leaf_bytes(s[a:b]))
            u8 = (
                torch.cat(parts)
                if parts
                else torch.zeros(0, dtype=torch.uint8, device=device)
            )
            return pad_to_multiple(u8, 4).view(torch.int32)

        # the transformed leaf table mirrors what the host reference path
        # (quantize_tree -> serialize_tree) would record in the manifest
        tree = unflatten(treedef, [l for _, l in named])
        spec_tree = quant_target_like(tree) if self.precodec == "int8" else tree
        tnamed, _ = flatten_with_names(spec_tree)
        leaves: List[LeafEntry] = []
        off = 0
        for name, l in tnamed:
            dt = dtype_name(l)
            shape = tuple(getattr(l, "shape", np.shape(l)))
            size = _numel(l) * DTYPES[dt][1].itemsize
            leaves.append(
                LeafEntry(name=name, dtype=dt, shape=shape, offset=off, size=size)
            )
            off += size
        return _StreamSpec(fn=build, leaves=leaves, total=off)

    # -- staging ------------------------------------------------------------

    def assemble(self, state: Any) -> Tuple[_StreamSpec, torch.Tensor]:
        """The transformed state as one ``int32`` word stream on the
        device (the serialized bytes, zero-padded to a whole word),
        enqueued on the caller's current stream, with its spec."""
        named, treedef = flatten_with_names(state)
        spec = self._spec_for(named, treedef)
        if spec.total == 0:
            raise ValueError("device precodec requires a non-empty state")
        return spec, spec.fn([leaf for _, leaf in named])

    def stage(
        self, step: int, state: Any, *, base_step: Optional[int] = None
    ) -> StagedPrecodec:
        """Assemble ``step``'s word stream and start the fused pass.

        The assembly is enqueued on the caller's current stream before
        this returns; the fused pass, the gather and the D2H run on the
        worker.  ``base_step`` is the engine's delta-base choice; the
        device only honors it when it still holds that step's words
        (otherwise the stage silently becomes a full snapshot and the
        returned buffers carry ``base_step=None``).
        """
        spec, words = self.assemble(state)
        ready = None
        if self._side is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        fut = self._exec.submit(self._run_stage, words, ready, step, base_step)
        return StagedPrecodec(step=step, base_step=base_step, spec=spec, future=fut)

    def _run_stage(
        self,
        words: torch.Tensor,
        ready: Optional[torch.cuda.Event],
        step: int,
        base_step: Optional[int],
    ) -> _StageResult:
        t0 = perf_counter()
        side = self._side
        with torch.cuda.stream(side) if side is not None else nullcontext():
            if side is not None:
                side.wait_event(ready)
                # allocated on the caller's stream, used (and later freed
                # as the base) on this one
                words.record_stream(side)
            use_base = (
                base_step is not None
                and self._base_step == base_step
                and self._base_words is not None
                and self._base_words.shape == words.shape
            )
            basew = self._base_words if use_base else torch.zeros_like(words)
            delta, meta = fused_precodec(
                words, basew, chunk_words=self.chunk_size // 4
            )
            meta_np = meta_to_numpy(meta)
            digests = digests_from_meta(meta_np)
            n_chunks = len(digests)
            # no base: the XOR against zeros IS the stream; every chunk ships
            mask = dirty_from_meta(meta_np) if use_base else np.ones(n_chunks, bool)
            dirty_idx = np.flatnonzero(mask)
            sub = (
                delta
                if len(dirty_idx) == n_chunks
                else delta.index_select(
                    0, torch.as_tensor(dirty_idx, device=delta.device)
                )
            )
            done = None
            if side is None:
                host = sub
            else:
                host = torch.empty(sub.shape, dtype=sub.dtype, pin_memory=True)
                host.copy_(sub, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
        self._base_words, self._base_step = words, step
        return _StageResult(
            base_step=base_step if use_base else None,
            mask=mask, digests=digests, dirty_idx=dirty_idx,
            host=host, done=done, stage_s=perf_counter() - t0,
        )

    def consume(
        self, staged: StagedPrecodec, base_stream: Optional[Buffer] = None
    ) -> StagedBuffers:
        """Block on the staged D2H and reconstruct the raw stream.

        For delta stages ``base_stream`` must be the raw stream of the
        base step (the engine's L0 twin keeps it resident); the stream
        is rebuilt as a copy of the base with the dirty chunks XORed in
        place — no full-state D2H ever happens for a delta step.
        """
        t0 = perf_counter()
        res = staged.future.result()
        if res.done is not None:
            res.done.synchronize()
        dirty_np = res.host.numpy().view(np.uint32)
        wait_s = perf_counter() - t0
        total, cs = staged.spec.total, self.chunk_size
        deltas: Dict[int, np.ndarray] = {}
        if res.base_step is None:
            stream_arr = dirty_np.reshape(-1).view(np.uint8)[:total]
        else:
            if base_stream is None or len(base_stream) != total:
                raise ValueError(
                    "staged delta consume requires the base step's stream"
                )
            stream_arr = np.frombuffer(base_stream, np.uint8).copy()
            for i, gi in enumerate(res.dirty_idx):
                a = int(gi) * cs
                b = min(a + cs, total)
                db = dirty_np[i].view(np.uint8)[: b - a]
                np.bitwise_xor(stream_arr[a:b], db, out=stream_arr[a:b])
                deltas[int(gi)] = db
        return StagedBuffers(
            stream=memoryview(stream_arr).toreadonly(),
            leaves=staged.spec.leaves,
            mask=res.mask,
            deltas=deltas,
            digests=res.digests,
            base_step=res.base_step,
            stage_s=res.stage_s,
            wait_s=wait_s,
        )

    def invalidate_base(self) -> None:
        """Drop the device-held base words (forces the next stage full)."""
        self._base_words = self._base_step = None

    def close(self) -> None:
        self._exec.shutdown(wait=False)
