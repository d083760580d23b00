"""One run of one cell: set-up, the measured window, the checks.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
both are data files found by name (``configs/<config>.json``,
``traffic/<mix>.json``), as are the cell's limits
(``limits/<cell>.json``), the end-to-end metrics
(``end_to_end/<metric>.py``) and the per-layer metrics
(``metrics/<metric>.py``). The configuration names its plain reference
(``reference/<name>.py``).

The system under test is ``repro_torch``: its model, its train step
(``build_train_step``, remat on, in place AdamW) under its
``deterministic_algorithms()``, and its ``CheckpointManager``. The
benchmark's loop calls them as a training job does. Two loops read a
mix:

* ``train``: ``setup_steps`` steps, then steps until the window's
  seconds are up. A save is due at the first step that ends after each
  fraction of the window in ``save_at``: the state is staged on the
  device after that step (``stage()``) and saved after the next
  (``save()``), its flush running on. Each save's persistence is the time from the end of its step to
  the ``subscribe`` callback of its ``flush_done``.
* ``resume``: ``setup_steps`` steps and a save of the last, flushed, with
  the node-local level (L1) of every node deleted and the files written
  out to the disk (so that no write-back of them falls into the
  window). Then, over and over, a
  new manager on the same root restores that step from the PFS onto the
  device, the restored leaves are copied into the live state, and the
  next step runs, as a job resumed after a failure does. The first time
  is set-up.

Inputs come from ``--seed`` (:mod:`ckpt_bench.inputs`). The correctness
numbers (:mod:`ckpt_bench.check`) are taken once the window has closed:
the first steps against the reference's, and every restore against the
benchmark's own device copy of the state it saved.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ckpt_bench import check, counts, trace
from ckpt_bench.inputs import make_batch, make_params
from ckpt_bench.reference.train import Readings, norm, train_steps, unclip_factor
from ckpt_bench.tree import flatten, tree_map

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "ckpt_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
FLUSH_GRACE_S = 60.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_reader(kind: str, name: str):
    """The ``read(rec)`` function of ``ckpt_bench/<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ckpt_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    """Everything a run reads about its cell."""

    name: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, cfg=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


# -- the program ------------------------------------------------------------


def model_config(cfg: Dict[str, Any]):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def checkpoint_config(cfg: Dict[str, Any], root: Path, device):
    from repro_torch.core import CheckpointConfig, theta_like

    ck = dict(cfg["checkpoint"])
    nodes, ppn = ck.pop("nodes"), ck.pop("ppn")
    return CheckpointConfig(root=str(root), cluster=theta_like(nodes, ppn),
                            device=str(device), **ck)


class Program:
    """The train state and step of ``repro_torch``, its parameters
    loaded from the benchmark's tree."""

    def __init__(self, cfg: Dict[str, Any], params: Any, device: torch.device):
        from repro_torch.models import get_model
        from repro_torch.train import OptConfig, TrainConfig, build_train_step
        from repro_torch.train.optimizer import init_opt_state

        model = get_model(model_config(cfg))
        self.module = model.build(device)
        tree = self.module.state_tree()
        mine, given = flatten(tree), dict(flatten(params))
        if {n for n, _ in mine} != set(given):
            raise ValueError(f"{cfg['name']}: the program's parameters are not the "
                             "reference's")
        with torch.no_grad():
            for n, p in mine:
                p.copy_(given[n])
        opt = OptConfig(**cfg["optimizer"])
        self.state = {"params": tree, "opt": init_opt_state(tree, opt),
                      "step": torch.zeros((), dtype=torch.int32, device=device)}
        self.step_fn = build_train_step(model, TrainConfig(opt=opt, remat=True))
        self.device = device

    def step(self, batch) -> float:
        self.state, metrics = self.step_fn(self.state, batch)
        self.grad_norm = metrics["grad_norm"]
        loss = float(metrics["loss"])
        sync(self.device)
        return loss

    def load(self, tree: Any) -> None:
        """Copy the leaves of ``tree`` (same names) into the live state."""
        src = dict(flatten(tree))
        with torch.no_grad():
            for n, d in flatten(self.state):
                d.copy_(src[n])


def program_readings(cfg: Dict[str, Any], params: Any, batches: List[Any],
                     device: torch.device) -> Readings:
    """The program's first steps from ``params`` on ``batches``, read as
    the window's set-up reads them (outside a run: the readings the
    limits are set from, and the tests)."""
    from repro_torch.launch.train import deterministic_algorithms

    prog = Program(cfg, params, device)
    got = Readings()
    with deterministic_algorithms():
        for j, batch in enumerate(batches):
            got.losses.append(prog.step(batch))
            if j == 0:
                read_first_gradients(got, prog, cfg)
    got.change_norms = change_norms(prog.state, params)
    return got


def read_first_gradients(got: Readings, prog: "Program", cfg: Dict[str, Any]) -> None:
    """Each leaf's gradient as the optimizer got it in the program's first
    step, read from its first moment (``mu / (1 - beta1)``), in float32
    on the host, its norm, and the step's global norm before the clip."""
    b1 = cfg["optimizer"]["beta1"]
    with torch.no_grad():
        got.first_grads = {n: (m.float() / (1 - b1)).cpu()
                           for n, m in flatten(prog.state["opt"]["mu"])}
    got.grad_norms = {n: norm(g) for n, g in got.first_grads.items()}
    got.global_norm = float(prog.grad_norm)
    got.unclip = unclip_factor(got.global_norm, cfg["optimizer"]["grad_clip"])


def change_norms(state: Any, start: Any) -> Dict[str, float]:
    """Each leaf's norm of its change from ``start``, as the leaf's own
    type holds ``start`` (rounded as the program rounded it when it
    loaded it)."""
    start = dict(flatten(start))
    return {n: norm(p.detach().double() - start[n].to(p.dtype).double())
            for n, p in flatten(state["params"])}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_copy(tree: Any) -> Any:
    with torch.no_grad():
        return tree_map(lambda t: t.detach().clone(), tree)


def meta_like(tree: Any) -> Any:
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def warm_precodec(state: Any, ck, device) -> None:
    """Stage the state twice on a device pre-codec of its own and keep
    both results until the second is read back: the kernels are loaded
    and the allocators hold the two staging buffers that alternating
    saves use, as in a job that has saved before."""
    from repro_torch.core.precodec import DevicePrecodec

    dp = DevicePrecodec(chunk_size=ck.chunk_size, precodec=ck.precodec, device=device)
    try:
        held = [dp.consume(dp.stage(0, state)) for _ in range(2)]
    finally:
        dp.close()
    del held


# -- what a run records -----------------------------------------------------


@dataclass
class Record:
    """A run's window, as the metrics' readers see it. Times are host
    seconds (``time.perf_counter``)."""

    cell: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    steps: List[Dict[str, Any]] = field(default_factory=list)
    saves: List[Dict[str, Any]] = field(default_factory=list)
    restores: List[Dict[str, Any]] = field(default_factory=list)
    trace: Optional[trace.Trace] = None
    flops_per_step: Optional[float] = None
    tokens_per_step: int = 0
    chunk_size: int = 0


def run_cell(cell: Cell, seed: int, seconds: float, *, traced: bool = False,
             device: Any = "cuda", t_process: Optional[float] = None,
             log=print, keep: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Set up, run the window, check; returns the result's fields
    (``keep``, when given, receives the run's :class:`Record`)."""
    from repro_torch.launch.train import deterministic_algorithms

    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    cfg, traffic = cell.cfg, cell.traffic
    ref = importlib.import_module(f"ckpt_bench.reference.{cfg['reference']}")
    root = Path(tempfile.mkdtemp(prefix="ckpt_bench_"))
    spans = trace.Spans()
    rec = Record(cell=cell.name, cfg=cfg, traffic=traffic,
                 tokens_per_step=traffic["global_batch"] * traffic["seq_len"],
                 flops_per_step=counts.train_flops(cfg, traffic["global_batch"],
                                                   traffic["seq_len"]))
    marks = [("start", time.perf_counter())]
    try:
        params = make_params(ref.param_specs(cfg), seed, dev)
        prog = Program(cfg, params, dev)
        pool = [make_batch(cfg, traffic, seed, j, dev) for j in range(traffic["batch_pool"])]
        marks.append(("inputs", time.perf_counter()))
        ck = checkpoint_config(cfg, root, dev)
        rec.chunk_size = ck.chunk_size
        loop = {"train": TrainLoop, "resume": ResumeLoop}[traffic["loop"]]
        run = loop(prog, pool, traffic, ck, spans, rec, log)
        with deterministic_algorithms():
            readings = run.setup(params)
            del params
            gc.collect()
            sync(dev)
            rec.setup_s = time.perf_counter() - t_process
            marks.append(("first steps and warm-ups", time.perf_counter()))
            log(f"setup_s {rec.setup_s:.3f}: before the cell {marks[0][1] - t_process:.3f} s, "
                + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
                file=sys.stderr)
            prof = trace.start() if traced else None
            t0 = spans.now()
            run.window(seconds)
            t1 = spans.now()
            events = trace.stop(prof) if traced else None
            late = run.settle()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        describe(rec, log)
        if traced:
            rec.trace = trace.reduce(events, spans, t0, t1)
            del events
        numbers = run.checks(late)
        del prog, run, pool
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_pool = [make_batch(cfg, traffic, seed, j, dev) for j in range(len(readings.losses))]
        ref_params = make_params(ref.param_specs(cfg), seed, dev)
        want = train_steps(ref, cfg, ref_params, ref_pool, cfg["optimizer"])
        del ref_params, ref_pool
        step_numbers, details = check.step_numbers(readings, want)
        numbers.update(step_numbers)
        log(f"{cell.name}: losses {details['losses']} against the reference's "
            f"{details['ref_losses']}; worst leaves: gradient {details['worst_grad_leaf']}, "
            f"change {details['worst_change_leaf']}; leaves not compared for their change "
            f"(reference gradient under {check.MOVING_SHARE:g} of the median leaf's): "
            f"{details['unmoved_leaves']}", file=sys.stderr)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if keep is not None:
        keep["record"] = rec
    return assemble(cell, rec, numbers, peak, dev, run_counts=late)


def describe(rec: Record, log) -> None:
    """One line a save and a restore of the window, on standard error."""
    for s in rec.saves:
        st, fl = s["stats"], s["stats"].flush
        log(f"save step {s['step']}: block_s={s['block_s']:.4f} stage_s={st.stage_s:.4f} "
            f"stage_wait_s={st.stage_wait_s:.4f} encode_s={st.encode_time:.4f} "
            f"local_s={st.local_time:.4f} raw={st.raw_bytes} stored={st.stored_bytes} "
            f"flush_s={fl.duration if fl else None} "
            f"persist_s={s['flush_done'] - s['step_end'] if s.get('flush_done') else None}",
            file=sys.stderr)
    for r in rec.restores:
        rd = r["read"]
        log(f"restore: s={r['t1'] - r['t0']:.4f} read_s={rd.duration if rd else None} "
            f"bytes_read={rd.bytes_read if rd else None}", file=sys.stderr)
    steps = sorted(x["t1"] - x["t0"] for x in rec.steps)
    if steps:
        med = steps[len(steps) // 2]
        log(f"steps: {len(steps)}, median {med:.4f} s, "
            f"min {steps[0]:.4f} s, max {steps[-1]:.4f} s", file=sys.stderr)
        saved = {s["step"] + 1 for s in rec.saves}   # the step after which save() ran
        slow = [x for x in rec.steps if x["t1"] - x["t0"] > 2 * med]
        for x in slow[:8]:
            before = [k for k in saved if k < x["step"]]
            after = (f", {x['step'] - max(before)} after the save() that followed step "
                     f"{max(before)}" if before else "")
            log(f"slow step {x['step']}: {x['t1'] - x['t0']:.4f} s{after}", file=sys.stderr)


def assemble(cell: Cell, rec: Record, numbers: Dict[str, float], peak: int,
             dev: torch.device, run_counts: Dict[str, int]) -> Dict[str, Any]:
    """The result's fields: the end-to-end metrics of the cell, or with a
    trace its per-layer metrics (those whose reader finds something)."""
    kind, chosen = ("metrics", cell.per_layer) if rec.trace else ("end_to_end", cell.end_to_end)
    metrics = {}
    for m in chosen:
        v = load_reader(kind, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": check.judge(numbers, cell.limits), "attempted": run_counts["attempted"],
           "failed": run_counts["failed"], "metrics": metrics, "device": device}
    if rec.trace is not None:
        device.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["breakdown"] = {"device_ops": trace.top(rec.trace.op_s),
                            "idle_gaps": trace.top(rec.trace.idle_s)}
    out["written_bytes"] = run_counts["written"]
    out["checks"] = {n: {"value": numbers.get(n), "limit": lim}
                     for n, lim in cell.limits.items()}
    return out


# -- the loops --------------------------------------------------------------


class _Loop:
    def __init__(self, prog: Program, pool, traffic, ck, spans: trace.Spans, rec: Record, log):
        self.prog, self.pool, self.traffic, self.ck = prog, pool, traffic, ck
        self.spans, self.rec, self.log = spans, rec, log
        self.readings = Readings()
        self.written = {"l1": 0, "pfs": 0}

    def timed(self, label: str, fn, *args):
        a = self.spans.now()
        out = fn(*args)
        self.spans.add(label, a, self.spans.now())
        return out

    def first_step(self, batch) -> float:
        """One of the first steps; the first records each leaf's first
        gradient as the optimizer got it."""
        loss = self.timed("setup_step", self.prog.step, batch)
        self.readings.losses.append(loss)
        if len(self.readings.losses) == 1:
            read_first_gradients(self.readings, self.prog, self.rec.cfg)
        return loss

    def record_change(self, start: Any) -> None:
        self.readings.change_norms = change_norms(self.prog.state, start)

    def manager(self):
        from repro_torch.core import CheckpointManager

        return CheckpointManager(self.ck)

    def drop_l1(self, mgr) -> None:
        for n in range(self.ck.cluster.n_nodes):
            mgr.local.drop_node(n)

    def count_written(self, stats) -> None:
        for st in stats:
            self.written["l1"] += st.stored_bytes
            self.written["pfs"] += st.flush.bytes_written if st.flush is not None else 0


class TrainLoop(_Loop):
    def setup(self, params) -> Readings:
        t = self.traffic
        for j in range(t["setup_steps"]):
            self.first_step(self.pool[j])
        self.record_change(params)
        self.i = t["setup_steps"]
        self.save_at = list(t.get("save_at", []))
        self.mgr = None
        if self.save_at:
            self.mgr = self.manager()
            self.done: Dict[int, float] = {}
            self.mgr.subscribe(lambda step: self.done.setdefault(step, time.perf_counter()))
            self.timed("warm_precodec", warm_precodec, {"train": self.prog.state}, self.ck,
                       self.prog.device)
        self.copy = None
        return self.readings

    def window(self, seconds: float) -> None:
        rec, prog, pool = self.rec, self.prog, self.pool
        t_start = time.perf_counter()
        dues = [t_start + f * seconds for f in self.save_at]
        staged = None
        while True:
            self.i += 1
            batch = pool[(self.i - 1) % len(pool)]
            a = self.spans.now()
            t0 = time.perf_counter()
            loss = prog.step(batch)
            t1 = time.perf_counter()
            self.spans.add("step", a, self.spans.now())
            rec.steps.append({"step": self.i, "t0": t0, "t1": t1, "loss": loss,
                              "beside_stage": staged is not None})
            if staged is not None:
                s0 = time.perf_counter()
                st = self.timed("save", self.mgr.save, staged["step"], {"train": prog.state})
                staged["block_s"] += time.perf_counter() - s0
                staged["stats"] = st
                rec.saves.append(staged)
                staged = None
            # a save that is due is made even when slow steps carry it past
            # the window
            if dues and t1 >= dues[0]:
                dues.pop(0)
                s0 = time.perf_counter()
                self.timed("stage", self.mgr.stage, self.i, {"train": prog.state})
                staged = {"step": self.i, "step_end": t1, "block_s": time.perf_counter() - s0}
                self.copy = (self.i, device_copy(prog.state))
            if staged is None and not dues and t1 - t_start >= seconds:
                break
        rec.window = (t_start, time.perf_counter())

    def settle(self) -> Dict[str, int]:
        """Wait for every save's flush (a minute at most); the counts."""
        failed = 0
        if self.mgr is not None:
            a = self.spans.now()
            end = time.perf_counter() + FLUSH_GRACE_S
            want = {s["step"] for s in self.rec.saves}
            while not want <= set(self.done) and time.perf_counter() < end:
                time.sleep(0.01)
            self.spans.add("flush_wait", a, self.spans.now())
            if want <= set(self.done):
                self.mgr.wait()
            for s in self.rec.saves:
                s["flush_done"] = self.done.get(s["step"])
            errors = self.mgr.flush_errors
            failed = sum(1 for s in self.rec.saves if s["flush_done"] is None) + len(errors)
            self.count_written(self.mgr.stats)
            self.mgr.close()
        return {"attempted": len(self.rec.steps) + len(self.rec.saves), "failed": failed,
                "written": dict(self.written)}

    def checks(self, late: Dict[str, int]) -> Dict[str, float]:
        numbers = {"failed_ops": late["failed"]}
        if self.copy is not None:
            step, want = self.copy
            mgr = self.manager()
            try:
                self.drop_l1(mgr)
                got_step, tree = mgr.restore(meta_like({"train": want}), step=step)
                bad = check.mismatched_bytes(tree["train"], want)
                numbers["restore_bad_bytes"] = int(bad) if got_step == step else -1
            finally:
                mgr.close()
        return numbers


class ResumeLoop(_Loop):
    def setup(self, params) -> Readings:
        t, prog = self.traffic, self.prog
        for j in range(t["setup_steps"]):
            self.first_step(self.pool[j])
        self.saved = t["setup_steps"]
        self.copy = device_copy(prog.state)
        mgr = self.manager()
        try:
            self.timed("save", mgr.save, self.saved, {"train": prog.state})
            self.timed("flush_wait", mgr.wait)
            if mgr.flush_errors:
                raise RuntimeError(f"the set-up save's flush failed: {mgr.flush_errors}")
            self.count_written(mgr.stats)
            self.drop_l1(mgr)
        finally:
            mgr.close()
        self.timed("sync", os.sync)
        self.target = meta_like({"train": prog.state})
        self.bad: List[torch.Tensor] = []
        self.losses: List[float] = []
        self.failures = 0
        loss = self.resume_once(first=True)
        self.readings.losses.append(loss)
        self.record_change(params)
        return self.readings

    def resume_once(self, first: bool = False) -> Optional[float]:
        prog, rec = self.prog, self.rec
        mgr = self.timed("manager", self.manager)
        try:
            a = self.spans.now()
            t0 = time.perf_counter()
            try:
                got, tree = mgr.restore(self.target, step=self.saved)
                sync(prog.device)
            except Exception as e:   # a restore that never comes
                if first:
                    raise
                self.log(f"restore failed: {e!r}", file=sys.stderr)
                self.failures += 1
                return None
            t1 = time.perf_counter()
            self.spans.add("restore", a, self.spans.now())
            read = mgr.last_read_result
        finally:
            self.timed("manager", mgr.close)
        if not first:
            rec.restores.append({"t0": t0, "t1": t1, "read": read})
        if got != self.saved:
            self.failures += 1
        self.bad.append(self.timed("check", check.mismatched_bytes, tree["train"], self.copy))
        self.timed("copy", prog.load, tree["train"])
        del tree
        loss = self.timed("first_step" if first else "step", prog.step,
                          self.pool[self.saved % len(self.pool)])
        if not first:
            rec.steps.append({"step": self.saved + 1, "t0": t1, "t1": time.perf_counter(),
                              "loss": loss, "beside_stage": False})
        self.losses.append(loss)
        return loss

    def window(self, seconds: float) -> None:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            self.resume_once()
        self.rec.window = (t_start, time.perf_counter())

    def settle(self) -> Dict[str, int]:
        n = len(self.rec.restores) + self.failures
        return {"attempted": n + len(self.rec.steps), "failed": self.failures,
                "written": dict(self.written)}

    def checks(self, late: Dict[str, int]) -> Dict[str, float]:
        bad = [int(b) for b in self.bad]
        first = self.losses[0]
        return {"failed_ops": late["failed"], "restore_bad_bytes": sum(bad),
                "replay_loss_mismatches": sum(1 for x in self.losses[1:] if x != first)}
