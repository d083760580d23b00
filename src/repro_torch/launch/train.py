"""End-to-end training driver with aggregated async checkpointing.

Counterpart of ``repro/launch/train.py``, with the same flags and
printed lines, plus ``--device`` (default ``cuda``). As the reference's
CLI, ``main`` trains on the host mesh (``make_host_mesh``): the state is
placed by the partition rules and stepped by ``make_train_step``.
Example (CPU smoke scale):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --device cpu --steps 30 --ckpt-every 10 \\
        --strategy stripe_aligned --nodes 4 --ppn 2

Restart (``--resume``) resumes from the deepest complete checkpoint
level, including optimizer moments and the data-pipeline cursor
(bit-exact batch replay). The loop is :func:`run`, which other drivers
call with their own :class:`~repro_torch.core.engine.CheckpointConfig`
(for example ``device_precodec=True``).

With the device pre-codec on, step N is staged on the device right
after it (``CheckpointManager.stage``) and saved after step N+1 has
run, so the fused pass and the dirty-chunk copy overlap the next step.

With a ``mesh``, :func:`run` places the state (and a restored one) on
it by ``train_state_specs`` and steps it with ``make_train_step``;
without one it steps plain tensors with ``build_train_step``. On a mesh
of more than one process, rank 0 alone holds the checkpoint manager (the
reference's single controller): before a save every rank gathers the
whole state (a collective), and a restore on rank 0 is broadcast.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import CheckpointConfig, CheckpointManager, SaveStats, theta_like
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelConfig, get_model
from repro_torch.models.sharding import place
from repro_torch.train import (
    OptConfig, TrainConfig, build_train_step, init_train_state, make_train_step,
)
from repro_torch.utils.convert import copy_tree_, whole_tensor
from repro_torch.utils.treelib import tree_leaves, tree_map


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    # checkpointing
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--strategy", default="stripe_aligned",
                    choices=["file_per_process", "posix", "mpiio",
                             "stripe_aligned", "gio_sync"])
    ap.add_argument("--codec", default="none",
                    choices=["none", "zstd", "zstd+delta"])
    ap.add_argument("--precodec", default="none", choices=["none", "int8"])
    ap.add_argument("--io-threads", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--ppn", type=int, default=2)
    ap.add_argument("--keep", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--partner-replication", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


@dataclass
class TrainRun:
    """What :func:`run` leaves behind: the live train state and data
    pipeline, and per-step and per-save records."""

    state: Any
    data: SyntheticTokens
    losses: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)     # synchronised, per step
    saves: List[SaveStats] = field(default_factory=list)  # with flush results
    flush_errors: List[Any] = field(default_factory=list)
    restored_step: Optional[int] = None
    restore_s: Optional[float] = None
    restore_read: Any = None   # the restore's PFS ReadResult; None when it read none


def run(
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    tcfg: TrainConfig,
    ckpt_cfg: Optional[CheckpointConfig],
    *,
    steps: int,
    ckpt_every: int,
    resume: Union[bool, int] = False,
    device: Any = "cuda",
    seed: int = 0,
    log: Callable[[str], None] = print,
    save_last: bool = True,
    mesh: Any = None,
) -> TrainRun:
    """Train to ``steps``, checkpointing every ``ckpt_every`` steps and
    at the last (``ckpt_every=0``: never; ``save_last=False``: all but the
    last) through a manager on
    ``ckpt_cfg``. ``resume`` restores the newest step (``True``; a cold
    start when there is none) or the given step before training on.
    The run uses deterministic algorithms (and cuBLAS's fixed workspace
    on a card), so a resumed run replays bit for bit. ``mesh``: a
    ``DeviceMesh`` to place the state on (module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # read when cuBLAS makes its handle: before the first matmul
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    lead = mesh is None or dist.get_rank() == 0
    mgr = CheckpointManager(ckpt_cfg) if ckpt_cfg is not None and lead else None
    try:
        with deterministic_algorithms():
            return _loop(model_cfg, data_cfg, tcfg, mgr, steps=steps, ckpt_every=ckpt_every,
                         resume=resume, dev=dev, seed=seed, log=log, save_last=save_last,
                         mesh=mesh, saving=ckpt_cfg is not None)
    finally:
        if mgr is not None:
            mgr.close()


@contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, then
    the caller's setting again. Uninitialised memory is not filled: nothing
    reads it, and filling the pre-codec's pinned staging buffers would
    cost seconds a save."""
    import torch.utils.deterministic as det

    was, was_fill = torch.are_deterministic_algorithms_enabled(), det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        det.fill_uninitialized_memory = was_fill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _restore(mgr, target, resume, mesh):
    """``(step, restored)`` from ``mgr``; raises ``FileNotFoundError``
    when there is no checkpoint to restore. On a mesh of more than one
    process rank 0 restores and broadcasts the whole tensors; every rank
    returns them."""
    step, restored = None, None
    one = mesh is None or dist.get_world_size() == 1
    if mgr is not None:
        try:
            step, restored = mgr.restore(target, step=None if resume is True else int(resume))
        except FileNotFoundError:
            if one:
                raise
    if one:
        return step, restored
    box = [step]
    dist.broadcast_object_list(box, src=0)
    if box[0] is None:
        raise FileNotFoundError("rank 0 found no checkpoint to restore")
    if restored is None:
        restored = tree_map(lambda x: whole_tensor(x).clone(), target)
    else:
        tree_map(whole_tensor, target)   # the gather the other ranks make
    for leaf in tree_leaves(restored):
        dist.broadcast(leaf, src=0)
    return box[0], restored


def _loop(model_cfg, data_cfg, tcfg, mgr, *, steps, ckpt_every, resume, dev, seed, log,
          save_last, mesh, saving):
    model = get_model(model_cfg)
    data = SyntheticTokens(data_cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(model, gen, tcfg, dev)
    if mesh is None:
        step_fn = build_train_step(model, tcfg)
    else:
        step_fn, state_specs, _ = make_train_step(model, tcfg, mesh, data.peek(0))
        state = place(state, mesh, state_specs)
    # a mesh of more than one process: every rank gathers the whole
    # state for rank 0's manager
    gather = mesh is not None and dist.get_world_size() > 1
    out = TrainRun(state=state, data=data)

    start = 0
    if resume is not False:
        if not saving:
            raise ValueError("resume needs a checkpoint config")
        try:
            t0 = time.perf_counter()
            target = {"train": state, "data": data.state_tree()}
            step, restored = _restore(mgr, target, resume, mesh)
            if mesh is None:
                copy_tree_(state, restored["train"])
            else:
                state = out.state = place(restored["train"], mesh, state_specs)
            data.load_state(restored["data"])
            del restored, target
            _sync(dev)
            out.restored_step, out.restore_s = step, time.perf_counter() - t0
            out.restore_read = mgr.last_read_result if mgr is not None else None
            start = int(whole_tensor(state["step"]))
            log(f"[resume] restored step {step} (train step {start})")
        except FileNotFoundError:
            if resume is not True:
                raise
            log("[resume] no checkpoint found; cold start")

    def save(step, full_state):
        st = mgr.save(step, full_state)
        stage = (f"stage {st.stage_s*1e3:.1f} ms (waited {st.stage_wait_s*1e3:.1f} ms), "
                 if mgr.cfg.device_precodec else "")
        log(
            f"[ckpt] step {step} saved: local {st.local_time*1e3:.1f} ms, "
            f"window {(st.encode_time + st.local_time)*1e3:.1f} ms, {stage}"
            f"{st.raw_bytes/1e6:.1f} MB raw -> {st.stored_bytes/1e6:.1f} MB"
        )

    staged = None   # (step, full state): staged on the device, saved after the next step
    for i in range(start, steps):
        batch = data.next()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        _sync(dev)
        dt = time.perf_counter() - t0
        out.losses.append(loss)
        out.step_s.append(dt)
        log(f"step {i+1:5d} loss {loss:.4f} step_time {dt*1e3:7.1f} ms")
        if staged is not None:
            save(*staged)
            staged = None
        due = ckpt_every > 0 and (save_last if i + 1 == steps else (i + 1) % ckpt_every == 0)
        if saving and due:
            train = tree_map(whole_tensor, state) if gather else state
            if mgr is None:    # not rank 0: the gather was this rank's part
                continue
            full_state = {"train": train, "data": data.state_tree()}
            if mgr.stage(i + 1, full_state):
                staged = (i + 1, full_state)
            else:
                save(i + 1, full_state)
    if staged is not None:
        save(*staged)
    if mgr is None:
        return out

    mgr.wait()
    out.saves = list(mgr.stats)
    out.flush_errors = list(mgr.flush_errors)
    flushes = [s for s in mgr.stats if s.flush is not None]
    if flushes:
        tot = sum(f.flush.bytes_written for f in flushes)
        dur = sum(f.flush.duration for f in flushes)
        log(
            f"[ckpt] {len(flushes)} flushes, {tot/1e6:.1f} MB, "
            f"avg flush {dur/len(flushes)*1e3:.1f} ms, "
            f"blocking overhead {sum(f.local_time for f in flushes)*1e3:.1f} ms "
            f"vs compute {sum(out.step_s)*1e3:.1f} ms"
        )
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        n_patches=cfg.n_patches,
        enc_seq=cfg.enc_seq if cfg.family == "audio" else 0,
        d_model=cfg.d_model,
        family=cfg.family,
    )
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, total_steps=args.steps),
        microbatches=args.microbatches,
    )
    ckpt_cfg = CheckpointConfig(
        root=args.root,
        cluster=theta_like(args.nodes, args.ppn),
        strategy=args.strategy,
        codec=args.codec,
        precodec=args.precodec,
        io_threads=args.io_threads,
        keep_n=args.keep,
        partner_replication=args.partner_replication,
        device=args.device,
    )
    mesh = make_host_mesh(args.device)
    try:
        result = run(cfg, data_cfg, tcfg, ckpt_cfg, steps=args.steps,
                     ckpt_every=args.ckpt_every, resume=args.resume, device=args.device,
                     mesh=mesh)
    finally:
        dist.destroy_process_group()
    if result.flush_errors:
        print("flush errors:", result.flush_errors)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
