"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on the
meta device.

Counterpart of ``repro/launch/dryrun.py``, with its CLI, ``KNOBS`` and
record keys. Torch has no HLO to compile and read, so a cell runs its
step (the port's ``build_train_step``, ``prefill`` or ``decode_step``)
at its full global shape on meta tensors, which hold no memory, under
``torch.utils.flop_counter.FlopCounterMode``; the mesh is a
``DeviceMesh`` over a fake process group of the mesh's size that this
process starts itself (rank 0, no peers, no device), as the reference
sets ``XLA_FLAGS`` for 512 placeholder devices before it imports jax.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k                      # one cell, single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

What a record holds, where the reference reads its compiled program:

* ``flops_global``: the counted step (matmuls, attention and
  convolutions; remat's recompute counts, as the reference's HLO has
  it). ``flops_per_dev`` is it over the data-parallel degree: the
  port's step shards the batch over ("pod", "data") and replicates its
  compute over "model".
* ``memory.argument_bytes``: the inputs' local shard bytes under their
  placements. ``memory.temp_bytes`` and ``peak_bytes`` are ``null``:
  meta tensors give no peak.
* the roofline row (``launch/roofline.py``) with ``bytes_per_dev =
  analytic_hbm_bytes`` and the port's own collectives: the just-in-time
  gather of every sharded parameter and, in training, the gradient
  all-reduce over the data-parallel ranks (result-shape bytes).

Results are cached under reports/dryrun_torch/ as JSON; --force reruns.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import RooflineTerms, model_flops
from repro_torch.models import get_model
from repro_torch.models.config import TORCH_DTYPES
from repro_torch.models.sharding import (
    P, _maybe, axis_size, cache_specs, fsdp_axes, is_spec, mesh_shape, param_specs,
    to_placements,
)
from repro_torch.train import OptConfig, TrainConfig, init_opt_state, train_state_specs
from repro_torch.train.train_step import batch_spec_tree, build_train_step
from repro_torch.utils.treelib import tree_leaves

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

# per-arch dry-run knobs (the reference's): grad-microbatching +
# optimizer/accum dtypes
KNOBS: Dict[str, Dict[str, Any]] = {
    "llama3-405b": dict(microbatches=4, opt_dtype="bfloat16", accum="bfloat16"),
    "qwen2-72b": dict(microbatches=4, opt_dtype="bfloat16", accum="bfloat16"),
    "llama4-scout-17b-a16e": dict(microbatches=2, opt_dtype="bfloat16", accum="bfloat16"),
    "llava-next-mistral-7b": dict(microbatches=2, opt_dtype="bfloat16", accum="float32"),
    "qwen2-moe-a2.7b": dict(microbatches=4, opt_dtype=None, accum="float32"),
    "recurrentgemma-2b": dict(microbatches=4, opt_dtype=None, accum="float32"),
    "whisper-small": dict(microbatches=4, opt_dtype=None, accum="float32"),
    "xlstm-350m": dict(microbatches=4, opt_dtype=None, accum="float32"),
}
DEFAULT_KNOBS = dict(microbatches=2, opt_dtype=None, accum="float32")


def fake_process_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (collectives do nothing; no peer, device or port), replacing
    a fake group of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def analytic_hbm_bytes(model, cell, mesh, knobs) -> float:
    """Per-device HBM traffic floor (B/step) from first principles (the
    reference's model, term for term):

    * weights are FSDP-gathered then read once per pass (fwd / remat-fwd
      / bwd for train; once for inference) at 1/TP residency;
    * optimizer update streams params + both moments (read+write);
    * boundary activations: one write + one read per remat checkpoint;
    * decode reads the local KV-cache shard once and appends once.
    """
    import math as _m

    cfg = model.cfg
    shape = mesh_shape(mesh)
    n_dev = _m.prod(shape.values())
    tp = int(shape["model"])
    fs = n_dev // tp
    struct = model.param_struct()
    param_bytes = sum(
        _m.prod(l.shape) * l.dtype.itemsize
        for l in tree_leaves(struct)
    )
    p_tp = param_bytes / tp          # post-gather residency
    p_loc = param_bytes / n_dev      # FSDP-sharded residency
    tokens_dev = cell.global_batch * cell.seq_len / max(1, fs)
    act_dt = 2  # bf16 activations
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_enc_layers
    if cell.kind == "train":
        k = int(knobs["microbatches"])
        opt_itemsize = 2 if knobs["opt_dtype"] == "bfloat16" else (
            TORCH_DTYPES[cfg.param_dtype].itemsize
        )
        weights = k * 3.0 * p_tp                    # fwd + remat-fwd + bwd
        grads = 4.0 * p_loc                          # accumulate rd+wr (x2)
        opt = 6.0 * (param_bytes * opt_itemsize / TORCH_DTYPES[cfg.param_dtype].itemsize) / n_dev + 2.0 * p_loc
        acts = 2.0 * L * tokens_dev * d * act_dt     # ckpt write + bwd read
        logits = 4.0 * tokens_dev * cfg.vocab_size / tp * act_dt
        return weights + grads + opt + acts + logits
    if cell.kind == "prefill":
        kv_dim = cfg.n_kv_heads * cfg.hd
        cache = 2.0 * L * tokens_dev * kv_dim * act_dt      # write k+v
        # chunked attention re-reads K/V per query chunk
        n_chunks = max(1, cell.seq_len // 1024)
        kv_reread = 2.0 * L * n_chunks * (cell.seq_len * kv_dim * act_dt) * (
            cell.global_batch / max(1, fs)
        )
        acts = 2.0 * L * tokens_dev * d * act_dt
        return p_tp + cache + kv_reread + acts
    # decode: weights once + cache shard read + append
    if cfg.family in ("ssm",):
        cache = 0.0  # O(1) recurrent state
    elif cfg.family == "hybrid":
        win = cfg.window or 2048
        n_attn = sum(1 for kk in cfg.layer_kinds() if kk == "attn")
        cache = (
            n_attn * cell.global_batch * win * cfg.n_kv_heads * cfg.hd * act_dt * 2
        ) / max(1, fs)
    else:
        s_kv = min(cell.seq_len, 2 ** 31)
        cache = (
            2.0 * L * cell.global_batch * s_kv * cfg.n_kv_heads * cfg.hd * act_dt
        ) / max(1, fs)
    return p_tp + cache


def local_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    """Bytes of every tensor of ``tree`` that one rank holds: its local
    shard under the placements of its spec in ``specs``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs, is_leaf=is_spec)):
        shape, _ = compute_local_shape_and_global_offset(
            x.shape, mesh, to_placements(spec, mesh), skip_offset=True)
        total += math.prod(shape) * x.dtype.itemsize
    return total


@dataclass
class Lowered:
    """A cell's step on meta inputs: ``fn(*args)``, and each argument's
    spec tree (``specs``) and whether the step updates it in place."""

    fn: Any
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    in_place: Tuple[bool, ...]
    grad: bool


def lower_cell(arch: str, shape_name: str, mesh: Any) -> Tuple[Lowered, Dict[str, Any]]:
    """Returns (the cell's step on meta inputs, meta), or raises."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    model = get_model(cfg)
    knobs = KNOBS.get(arch, DEFAULT_KNOBS)
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "knobs": {k: str(v) for k, v in knobs.items()},
    }
    params = model.param_struct()
    pspecs = param_specs(model, mesh)

    if cell.kind == "train":
        tcfg = TrainConfig(
            opt=OptConfig(state_dtype=knobs["opt_dtype"]),
            microbatches=knobs["microbatches"],
            accum_dtype=knobs["accum"],
        )
        batch = model.batch_struct(cell.global_batch, cell.seq_len)
        state = {
            "params": params,
            "opt": init_opt_state(params, tcfg.opt),
            "step": torch.zeros((), dtype=torch.int32, device="meta"),
        }
        sspecs = train_state_specs(model, mesh, tcfg)
        bspecs = batch_spec_tree(model, mesh, batch)
        return Lowered(build_train_step(model, tcfg), (state, batch), (sspecs, bspecs),
                       (True, False), grad=True), meta

    if cell.kind == "prefill":
        batch = model.batch_struct(cell.global_batch, cell.seq_len)
        bspecs = batch_spec_tree(model, mesh, batch)
        fn = lambda p, b: model.prefill(p, b, s_max=cell.seq_len)
        return Lowered(fn, (params, batch), (pspecs, bspecs), (False, False),
                       grad=False), meta

    if cell.kind == "decode":
        cache = model.cache_struct(cell.global_batch, cell.seq_len)
        cspecs = cache_specs(model, mesh, cell.global_batch, cell.seq_len)
        F = fsdp_axes(mesh)
        tok = torch.zeros((cell.global_batch, 1), dtype=torch.int32, device="meta")
        tok_spec = P(_maybe(cell.global_batch, F, mesh), None)
        return Lowered(model.decode_step, (params, cache, tok), (pspecs, cspecs, tok_spec),
                       (False, False, False), grad=False), meta

    raise ValueError(cell.kind)


def _collectives(lowered: Lowered, mesh: Any, kind: str, knobs) -> Dict[str, int]:
    """The port's collectives a step, result-shape bytes per device: the
    whole bytes of every parameter that is not replicated (gathered just
    in time) and, in training over more than one data-parallel rank, of
    the gradients averaged over them."""
    params, pspecs = lowered.args[0], lowered.specs[0]
    if kind == "train":
        params, pspecs = params["params"], pspecs["params"]
    leaves = tree_leaves(params)
    specs = tree_leaves(pspecs, is_leaf=is_spec)
    gather = sum(math.prod(x.shape) * x.dtype.itemsize
                 for x, s in zip(leaves, specs) if any(e is not None for e in s))
    out = {"all-gather": gather, "all-reduce": 0}
    if kind == "train" and axis_size(mesh, fsdp_axes(mesh)) > 1:
        k = int(knobs["microbatches"])
        out["all-reduce"] = sum(
            math.prod(x.shape) * (TORCH_DTYPES[knobs["accum"]].itemsize if k > 1
                                  else x.dtype.itemsize)
            for x in leaves)
    out["total"] = out["all-gather"] + out["all-reduce"]
    return out


def run_cell(
    arch: str, shape_name: str, *, multi_pod: bool, force: bool = False,
    mesh: Any = None, report_dir: Optional[Path] = None,
) -> Dict[str, Any]:
    from torch.utils.flop_counter import FlopCounterMode

    rdir = report_dir or REPORT_DIR
    rdir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = rdir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, cell)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "kind": cell.kind, "status": "skip" if not ok else "pending",
    }
    if not ok:
        rec["skip_reason"] = why
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    if mesh is None:
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    t0 = time.perf_counter()
    try:
        lowered, meta = lower_cell(arch, shape_name, mesh)
        t_lower = time.perf_counter() - t0
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as counter, torch.set_grad_enabled(lowered.grad):
            outputs = lowered.fn(*lowered.args)
        t_run = time.perf_counter() - t1
        flops_global = int(counter.get_total_flops())
        dp = axis_size(mesh, fsdp_axes(mesh))
        flops_per_dev = flops_global / dp
        model = get_model(cfg)
        knobs = KNOBS.get(arch, DEFAULT_KNOBS)
        args_b = [local_bytes(a, s, mesh) for a, s in zip(lowered.args, lowered.specs)]
        alias = sum(b for b, inplace in zip(args_b, lowered.in_place) if inplace)
        if cell.kind == "train":
            out_b = alias
        else:   # (cache, logits): the cache by its specs, logits by batch
            cache, logits = outputs if cell.kind == "prefill" else outputs[::-1]
            out_b = local_bytes(cache, cache_specs(model, mesh, cell.global_batch,
                                                   cell.seq_len), mesh)
            out_b += local_bytes(logits, P(_maybe(logits.shape[0], fsdp_axes(mesh), mesh),
                                           None), mesh)
        n_active = model.param_count(active_only=True)
        mf = model_flops(cell.kind, n_active, cell.global_batch, cell.seq_len)
        coll = _collectives(lowered, mesh, cell.kind, knobs)
        terms = RooflineTerms(
            flops_per_dev=float(flops_per_dev),
            bytes_per_dev=float(analytic_hbm_bytes(model, cell, mesh, knobs)),
            coll_bytes_per_dev=float(coll["total"]),
            n_chips=n_chips,
            model_flops_global=mf,
            coll_breakdown={k: v for k, v in coll.items() if k != "total"},
        )
        rec.update(meta)
        rec.update(
            {
                "status": "ok",
                "n_chips": n_chips,
                "lower_s": round(t_lower, 2),
                "compile_s": round(t_run, 2),   # the counted meta step
                "flops_global": flops_global,
                "memory": {
                    "argument_bytes": sum(args_b),
                    "output_bytes": out_b,
                    "temp_bytes": None,
                    "temp_bytes_note": "not measured: meta tensors give no peak",
                    "alias_bytes": alias,
                    "peak_bytes": None,
                    # live per device without temporaries (in-place
                    # arguments counted once)
                    "per_device_bytes": sum(args_b) + out_b - alias,
                },
                "cost": {"flops": flops_per_dev},
                "cost_corrected": {
                    "flops_per_dev": flops_per_dev,
                    "traffic_bytes_per_dev": None,
                    "n_while": 0,
                    "max_trip": 0,
                },
                "roofline": terms.row(),
                "n_params_active": n_active,
            }
        )
    except Exception as e:  # record the failure; the harness keeps going
        rec.update(
            {
                "status": "error",
                "error": repr(e),
                "traceback": traceback.format_exc()[-4000:],
            }
        )
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = args.arch or (list(ARCHS) if args.all else ["tinyllama-1.1b"])
    shapes = args.shape or list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_bad = 0
    for multi_pod in meshes:
        fake_process_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(
                    arch, shape, multi_pod=multi_pod, force=args.force, mesh=mesh
                )
                status = rec["status"]
                if status == "ok":
                    r = rec["roofline"]
                    mem = rec["memory"]["per_device_bytes"] / 2**30
                    print(
                        f"[{rec['mesh']}] {arch:24s} {shape:12s} OK  "
                        f"meta step {rec['compile_s']:7.1f}s  mem/dev {mem:6.2f} GiB  "
                        f"dom={r['dominant']:10s} "
                        f"terms(c/m/n)=({r['compute_s']:.3f}/{r['memory_s']:.3f}/"
                        f"{r['collective_s']:.3f})s  roofline_frac={r['roofline_fraction']:.3f}"
                    )
                elif status == "skip":
                    print(f"[{rec['mesh']}] {arch:24s} {shape:12s} SKIP ({rec['skip_reason'][:60]})")
                else:
                    n_bad += 1
                    print(f"[{rec['mesh']}] {arch:24s} {shape:12s} ERROR {rec['error'][:120]}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
