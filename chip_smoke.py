#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (an H100), end to end.

    python3 chip_smoke.py [--layers N]

Phase 0 prints the card and builds the five CUDA kernels from the
sources in this checkout (``src/repro_torch/kernels/*/csrc/*.cu``, with
``nvcc``, all started together, into ``build/repro_torch/``).

Phase 1 holds each kernel against its plain PyTorch version on the card,
at the shapes a full-depth train state gives it (those of phase 4) and
on constructed edge cases, and
times both (and, for dequantize, the one PyTorch call that computes the
same function). Equality is exact (tolerance zero).

Phase 2 is the main path: the training state of qwen1.5-0.5b at its
published widths (``src/repro/configs/qwen1_5_0_5b.py``: 24 layers,
d_model 1024, d_ff 2816, vocab 151936, untied output, QKV bias), cut to
``--layers`` (6 by default), with AdamW moments, all float32 from a
NumPy seed, lives on the card. Three
steps go through ``CheckpointManager.stage``/``save`` with the device
pre-codec (strategy stripe_aligned, codec zstd+delta, 1 MiB chunks,
16 ranks), updating the state in place between ``stage`` and ``save``
as a torch optimizer does; then every step is restored from the PFS on a
3x1 cluster with L1 dropped and compared byte for byte with a host copy.
Outside the timers, ``digest_array`` of every leaf on the card before
each ``stage`` must equal that of the restored leaf (and a few leaves
the host ``digest_ref`` of their host copy). A second manager saves an
int8 anchor and delta, whose restores must equal the plain quantize
followed by the host dequantize, and ``dequantize_tree_reference`` (one
dequantize launch per leaf, on the card) of the staged state's
quantized tree, exactly.

Phase 3 runs the pre-fusion chain on a full-depth train state of its
own (24 layers, the widths of phase 2, its own seed): the state's
word stream (the pre-codec's own assembly) before and after a fine-tune
of the top layers, ``xor_delta`` of the two, one ``checksum_u32`` per
1 MiB chunk and the per-chunk dirty counts as one reduction, held equal
to ``fused_precodec`` of the same streams; both wall times are logged.
``--layers`` cuts phase 2's depth (never a width) and no other phase's.

Phase 4 is the port's trainer (``repro_torch.launch.train.run``) at
qwen1.5-0.5b's full width cut to 6 of its 24 layers (``PHASE4_LAYERS``,
since phase 10 came; a 4,659,204,104-byte state; float32 params, bfloat16 compute,
batch 4 x 2048 tokens, remat) under deterministic algorithms: run A
trains steps 1-4 and checkpoints steps 2 and 4 with the device
pre-codec (so ``fused_precodec`` runs on the trainer's own saves); run
B, a fresh model, pipeline and manager on the same root, restores step
2 from the PFS with L1 dropped and replays steps 3-4. Run B's state
must equal run A's byte for byte, device digest for digest and batch
cursor for cursor, and so must step 4 restored from the PFS. It prints
the losses, step time, tokens/s, peak device memory and each save's and
restore's times, and a profile of one more (clean) step: device time
by kernel and the device's busy share, from a trace of the device's
activity only. Before run A, one step at the same widths and sequence
length, cut to two layers, runs on the card and through the port's CPU
step from the same state on the same batch: loss, grad_norm, each
leaf's mu and update norm must agree within ``REF_STEP_TOL``.
``--layers`` never cuts phase 4.

Phase 5 serves the trainer's checkpoints (``repro_torch.serve``): phase
4's run A flushed steps 2 (anchor) and 4 (delta) to the PFS. First the
serving path at full widths cut to two layers (prefill of 2 x 2048
tokens, 16 greedy decode steps) runs on the card and through the port's
CPU, teacher-forced on the card's tokens, within ``SERVE_REF_TOL``. Then
a serving manager on another geometry (2x1) cold-starts a two-replica
``ServeFleet`` from step 2 at phase 4's depth (every replica byte- and
digest-equal to a full restore of step 2), both replicas generate the
same 64 greedy tokens for 8 prompts of 2048 tokens, the follower
hot-swaps the fleet onto step 4 while a client generates in a loop (no
generate dropped or torn, versions never going back, the served digests
equal run A's step-4 params), and a serving snapshot (params, KV cache,
next token) saved with the device pre-codec after 32 tokens restores
from the PFS into a fresh server that emits the other 32 tokens
identically. It prints the cold start's times, bytes, cache hits and
reader balance, prefill and decode times, tokens/s, swap_s, the
snapshot's stage, window, flush and restore times, and peak device
memory. ``--layers`` never cuts phase 5.

Phase 6 is the control plane (``repro_torch.control``): two training
jobs, each holding a full-width train state on the card (its own seed),
cut to 6 of the 24 layers (``PHASE6_LAYERS``), checkpoint through one
``ControlPlane`` over one PFS root (budget of 2 pending flushes, a
bandwidth cap of a quarter of the rate at which phase 2's anchor flushed
unthrottled). ``finetune`` (priority 1) saves its anchor, whose flush
runs under the cap, then a top-4-layer step 2 that queues behind it;
``pretrain`` (priority 4) saves its anchor, which preempts finetune's
queued step 2 (parked as ``flush_partial``); both anchors flush through
the fair-share limiter at 4:1; finetune's step 2 drains to
``flush_done`` once the budget frees. Checks: one preemption, the budget
never above 2, no flush errors, the aggregate never faster than the cap,
pretrain's step 1 and finetune's step 2 restored on 3x1 with L1 dropped
equal to their host copies and pre-stage digests, and a fresh plane
recovering both jobs from ``registry.json``. It prints each tenant's
saves and flushes, the bytes each flushed while both were backlogged,
``simulate_flush_shared``'s prices, the restores, peak device memory and
free disk. Everything under the run's temporary directory (the roots
that phases 4 and 5 leave) is removed first. ``--layers`` never cuts
phase 6.

Phase 7 runs the MoE and VLM families of the port at published widths,
with everything under the run's temporary directory removed first.
qwen2-moe-a2.7b (``src/repro/configs/qwen2_moe_a2_7b.py``: d_model
2048, 16/16 heads, 60 routed experts top-4 of width 1408, 4 shared of
width 5632, vocab 151936, QKV bias, float32 params, bf16 compute) is cut
to one of its 24 layers (a 14.3 GB train state; a pre-codec stage holds
about four times its state): one step at batch 2 x 256 against the
port's CPU (also the aux loss, and every router selection that flips
between the two must be a near tie, ``ROUTER_TIE_TOL``); run A trains
steps 1-3 at batch 4 x 2048 (the trainer's deterministic ``run``)
saving step 2 (an anchor, staged beside step 3; the last step is not
saved, as in phases 8-10) with the device pre-codec; run B restores
step 2 from the PFS with L1 dropped and
replays step 3, which must equal run A's byte for byte, digest for
digest, cursor for cursor; prefill of 2 x 2048 and 16 decode steps from
run B's params against the CPU (``SERVE_REF_TOL`` on every step routed
alike on both sides); profiles of one clean step and of one MoE FFN
(dispatch and combine against the expert products).
llava-next-mistral-7b (``src/repro/configs/llava_next_mistral_7b.py``:
d_model 4096, 32/8 heads, d_ff 14336, vocab 32000, 576 patches, bf16
params and moments) is cut to two of its 32 layers (a 4.19 GB train
state): one step of 576 patches and 32 text tokens against the CPU,
prefill with patches and 16 decode steps against the CPU, then the
trainer takes one step of 4 x (576 patches + 1,472 text tokens) and
saves it with the device pre-codec; restored from the PFS on 3x1 with L1
dropped it must equal its host copy and pre-stage digests. ``--layers``
never cuts phase 7.

Phase 8 runs the recurrent families of the port at published widths,
with everything under the run's temporary directory removed first.
xlstm-350m (``src/repro/configs/xlstm_350m.py``: 24 layers, 18 mLSTM
and 6 sLSTM in the pattern m,m,m,s, d_model 1024, 4 heads, vocab 50304,
float32 params, bf16 compute) at full depth, a 5,772,990,144-byte train
state: float32 steps against the port's CPU of one period (the sLSTM
in it) at 8 x 8 tokens and of its three mLSTM layers at 1 x 2048 (two
mLSTM chunks carry state); run A trains steps 1-3 at batch 128 x 64
(every loss finite) saving step 2 (staged beside step 3) with the device
pre-codec as an anchor; run B restores step 2 from the
PFS with L1 dropped and replays step 3, equal byte for byte, digest for
digest, cursor for cursor; the sLSTM's share of a step (a period's step
against its three mLSTMs') and a device profile of a period's step;
``Server.generate`` of 8 x 2048 + 16 tokens from run B's params and a
serving snapshot (params, recurrent state, next token) after 8 tokens,
restored from the PFS into a fresh server that emits the other 8
identically; then prefill of 2 x 2048 and 16 decode steps of the three
mLSTM layers against the CPU and against teacher forcing on the card, in
float32 (``SERVE_REF_TOL_F32``). The reference's sLSTM at these widths
is chaotic and its backward grows about twice a token (see
``XLSTM_PERIOD_REF``): two computations agree on it only over its first
tokens, and the 24 layers' gradients overflow float32 from 256 tokens
on, so the trainer runs 64-token sequences (4 x 2048 before, NaN from
step 1).
recurrentgemma-2b (``src/repro/configs/recurrentgemma_2b.py``: d_model
2560, 10 query heads and 1 KV head of 256, d_ff 7680, vocab 256000
tied, window 2048, float32 params with float32 gates, bf16 compute) cut
to one period of 3 of its 26 layers (rglru, rglru, attn; a
10,947,840,000-byte state): one step at 1 x 512 against the CPU; run A
trains steps 1-2 at 1 x 4096 (past the window) saving step 1 (staged
beside step 2);
run B restores step 1 and replays step 2 byte for byte; serving from run
B's params (generate 4 x 4096 + 16, so the ring buffers wrap; a snapshot
of params, ring caches and RG-LRU state after 8 tokens) and decode
against teacher forcing on the card (``SERVE_REF_TOL``). ``--layers``
never cuts phase 8.

Phase 9 runs whisper-small, the encoder-decoder, at its published widths
and full depth (``src/repro/configs/whisper_small.py``: 12 encoder and 12
decoder layers, d_model 768, 12 heads, d_ff 3072, vocab 51865 tied,
enc_seq 1500, float32 params, bf16 compute; 239,435,520 parameters, a
2,873,226,240-byte train state), with everything under the run's
temporary directory removed first: one float32 step at 2 + 2 layers
(batch 1 x (1,500 frames, 64 tokens)) against the port's CPU
(``REF_STEP_TOL``), and prefill of 2 x (1,500 frames, 64 tokens) and 16
decode steps at 2 + 2 layers against the CPU teacher-forced on the
card's tokens (``SERVE_REF_TOL``); run A trains steps 1-3 at batch 16 x
(1,500 frames + 448 decoder tokens) saving step 2 (an anchor, staged
beside step 3) with the device pre-codec; run B restores step 2 from
the PFS with L1 dropped and replays step 3, equal byte for byte, digest
for digest, cursor for cursor; ``Server.generate`` of 8 x (1,500 frames,
32 tokens) + 64 tokens from run B's params, and a serving snapshot
(params, the ``WhisperCache`` with the cross K/V of the encoder's
memory, the next token) after 32 tokens, restored from the PFS into a
fresh server (the cache digest for digest: the frames are not encoded
again) that emits the other 32 identically. It prints the losses, the
replayed step's decoder tokens/s and frames/s, peak device memory, the
save's and restore's times, prefill and decode times, the snapshot's
times, and ``roofline.model_flops`` (6·N·D over the decoder's tokens
only) over the step and ``PEAK_FLOPS``. ``--layers`` never cuts phase 9.

Phase 10 runs the mesh layer: phase 4's model (qwen1.5-0.5b at full
width, ``PHASE4_LAYERS`` of its 24 layers), batch 4 x 2048, seed,
``TrainConfig`` and checkpoint config through the trainer on
``make_host_mesh("cuda")``, a 1x1 ``("data", "model")`` ``DeviceMesh``
on an nccl group of world size 1: the state placed by
``train_state_specs`` (the reference's partition rules; every leaf a
DTensor with those placements), each step ``make_train_step``'s. Run A
takes steps 1-3 saving step 2 (an anchor, staged beside step 3) with the
device pre-codec, which reads the DTensor leaves' local tensors; run B
restores step 2 from the PFS with L1 dropped into its mesh-placed state
and replays step 3 byte for byte, digest for digest, cursor for cursor.
Step 2's chunk digests and leaf table must equal phase 4's step 2: on
one device the mesh step is ``build_train_step``'s bit for bit. It
prints the steps' times, the save's window and flush, the restore and
peak device memory. The group is destroyed at the end. ``--layers``
never cuts phase 10.

After phases 2 and 4-6, within phases 7 and 8, and after phases 9 and 10, the pinned host blocks that
PyTorch's caching host allocator keeps (the pre-codec's D2H buffers) go
back to the system (``release_host_cache``): kept, they filled the
host's 96 GiB in phase 7.

Prints the card's name and power limit, per-step numbers, one JSON line
of kernels, and last ``{"ok": true, "device": {...}}``. Exits non-zero
(with no result) without a CUDA device, outside the repository, or when
any check fails. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's memory rate is repro_torch.launch.roofline.HBM_BW (read in
# bound_ms, after the checkout's src is on the path)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEED = 20211203

# qwen1.5-0.5b (src/repro/configs/qwen1_5_0_5b.py)
VOCAB, D_MODEL, D_FF, N_LAYERS = 151936, 1024, 2816, 24
# the depths of qwen1.5-0.5b's phases, cut (never a width) so that the
# script ends within the 1,200 s a run may take: phase 2's default and
# phase 6's (12 since phase 7 came, 6 since phase 10), phases 4, 5 and
# 10's (12 since phase 8, 6 since phase 10; 24 before). The embedding
# and head are 80 % of the state at 6 layers.
PHASE2_LAYERS = 6
PHASE6_LAYERS = 6
PHASE4_LAYERS = 6
LAYER_SHAPES = {
    "wq": (D_MODEL, D_MODEL), "wk": (D_MODEL, D_MODEL),
    "wv": (D_MODEL, D_MODEL), "wo": (D_MODEL, D_MODEL),
    "bq": (D_MODEL,), "bk": (D_MODEL,), "bv": (D_MODEL,),
    "ln1": (D_MODEL,), "ln2": (D_MODEL,),
    "w_gate": (D_MODEL, D_FF), "w_up": (D_MODEL, D_FF), "w_down": (D_FF, D_MODEL),
}
CHUNK_SIZE = 1 << 20
DEVICE = "cuda"


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def log(*a):
    print(*a, flush=True)


# -- timing ---------------------------------------------------------------


def time_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    """max |a - b| over two equal-shape tensors, in int64/float64 slices."""
    import torch

    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    x, y = a.reshape(-1), b.reshape(-1)
    wide = torch.float64 if a.dtype.is_floating_point else torch.int64
    err = 0.0
    for i in range(0, x.numel(), 1 << 26):
        d = (x[i : i + (1 << 26)].to(wide) - y[i : i + (1 << 26)].to(wide)).abs()
        if d.numel():
            err = max(err, float(d.max()))
    if a.dtype.is_floating_point and not torch.equal(a.isnan(), b.isnan()):
        err = float("inf")
    return err


def same_floats(a, b):
    """Equal bit for bit, except that any NaN matches any NaN."""
    import torch

    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    for i in range(0, a.numel(), 1 << 26):
        x, y, m = (t.reshape(-1)[i : i + (1 << 26)] for t in (a, b, nan))
        if not torch.equal(x.view(torch.int32)[~m], y.view(torch.int32)[~m]):
            return False
    return True


def bound_ms(n_bytes, n_ops):
    from repro_torch.launch.roofline import HBM_BW

    t_b = n_bytes / HBM_BW * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -- the state ------------------------------------------------------------


def state_specs(n_layers):
    """(path, shape) of every f32 leaf of params; mu and nu mirror it."""
    specs = [(("embed",), (VOCAB, D_MODEL)), (("final_norm",), (D_MODEL,)),
             (("out",), (VOCAB, D_MODEL))]
    specs += [(("layers", k), (n_layers, *s)) for k, s in LAYER_SHAPES.items()]
    return specs


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def state_words(n_layers):
    """Words of the serialized state: params, mu, nu, count and step."""
    return 3 * sum(_numel(s) for _, s in state_specs(n_layers)) + 2


def quantized_values(n_layers):
    """Values of the grouped int8 launch: every leaf of >= 4096 values."""
    return 3 * sum(_numel(s) for _, s in state_specs(n_layers) if _numel(s) >= 4096)


def empty_state(n_layers, device):
    """The train state's structure, uninitialised, on ``device`` (on
    "meta" it is a restore target: a restore reads names, not values)."""
    import torch

    def tree():
        t = {"embed": None, "final_norm": None, "out": None, "layers": {}}
        for path, shape in state_specs(n_layers):
            leaf = torch.empty(shape, dtype=torch.float32, device=device)
            if len(path) == 1:
                t[path[0]] = leaf
            else:
                t["layers"][path[1]] = leaf
        return t

    return {"params": tree(), "opt": {"mu": tree(), "nu": tree(),
                                      "count": torch.zeros((), dtype=torch.int32, device=device)},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_state(n_layers, device, pool, seed=SEED):
    """The train state on ``device``, values from a NumPy seed: params and
    mu standard normal, nu positive (|N(0,1)| * 1e-3 + 1e-8)."""
    import numpy as np
    import torch

    block = 1 << 24
    state = empty_state(n_layers, device)
    jobs = []
    for gi, (group, t) in enumerate((("params", state["params"]),
                                     ("mu", state["opt"]["mu"]),
                                     ("nu", state["opt"]["nu"]))):
        for li, (path, _) in enumerate(state_specs(n_layers)):
            leaf = t[path[0]] if len(path) == 1 else t["layers"][path[1]]
            flat = leaf.view(-1)
            for bi, lo in enumerate(range(0, flat.numel(), block)):
                jobs.append((group, flat, lo, min(lo + block, flat.numel()), (gi, li, bi)))

    def gen(job):
        group, flat, lo, hi, key = job
        a = np.random.default_rng([seed, *key]).standard_normal(hi - lo, dtype=np.float32)
        if group == "nu":
            a = np.abs(a) * np.float32(1e-3) + np.float32(1e-8)
        return job, a

    for (group, flat, lo, hi, _), a in pool.map(gen, jobs):
        flat[lo:hi].copy_(torch.from_numpy(a))
    sync()
    return state


def data_config(cfg, seq_len, global_batch, seed=SEED):
    """The trainer's pipeline for ``cfg``: ``global_batch`` x ``seq_len``
    tokens, and a VLM's patches or an audio model's frames (as
    ``repro_torch.launch.train.main`` builds it)."""
    from repro_torch.data import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
                      seed=seed, n_patches=cfg.n_patches,
                      enc_seq=cfg.enc_seq if cfg.family == "audio" else 0,
                      d_model=cfg.d_model, family=cfg.family)


def cut_depth(cfg, n_layers):
    """``cfg`` cut to ``n_layers`` (an encoder-decoder's encoder too:
    n_layers + n_layers)."""
    return cfg.replace(n_layers=n_layers, **({"n_enc_layers": n_layers} if cfg.encdec else {}))


def depth(cfg):
    """``cfg``'s layers as a log line names them: ``"2 + 2"`` for an
    encoder-decoder."""
    return f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.encdec else str(cfg.n_layers)


def leaves(tree):
    from repro_torch.utils.treelib import flatten_with_names

    return flatten_with_names(tree)[0]


def fine_tune_top_layers(state):
    """In place: a fine-tune of the top four layers (params, mu, nu)."""
    for t in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for leaf in t["layers"].values():
            leaf[-4:].mul_(0.999).add_(1e-4)     # the top four layers
    state["opt"]["count"].add_(1)
    state["step"].add_(1)


def update_everything(state):
    """In place: a full AdamW-like step over every leaf."""
    for t in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for _, leaf in leaves(t):
            leaf.mul_(0.999).add_(1e-4)
    state["opt"]["count"].add_(1)
    state["step"].add_(1)


def host_copy(state):
    return [(n, t.detach().to("cpu", copy=True)) for n, t in leaves(state)]


def same_bytes(got, want, what):
    """Two lists of (name, tensor), on any devices, equal in names,
    dtypes, shapes and bytes: floats compare as integers, so NaN payloads
    count (the xLSTM's state is NaN after its first update) and -0.0 is
    not 0.0."""
    import torch

    if [n for n, _ in got] != [n for n, _ in want]:
        raise AssertionError(f"{what}: other leaves")
    for (n, x), (_, y) in zip(got, want):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: leaf {n} is {x.dtype}{tuple(x.shape)}, "
                                 f"not {y.dtype}{tuple(y.shape)}")
        if x.is_floating_point():
            as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.view(as_int), y.view(as_int)
        if not torch.equal(x, y.to(x.device)):
            raise AssertionError(f"{what}: leaf {n} differs")


# -- phase 1 --------------------------------------------------------------


def phase1_fused(n_main, report):
    import torch

    from repro_torch.kernels.fused.ops import fused_precodec, fused_precodec_plain

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cw_main = CHUNK_SIZE // 4
    cases = [
        ("main", n_main, cw_main),
        ("ragged_tail", 5 * cw_main + 12345, cw_main),
        ("single_chunk", 100_003, cw_main),
        ("8MiB_chunks", 3 * 2_097_152 + 777, 2_097_152),
    ]
    errs = {}
    for name, n, cw in cases:
        cur = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda", generator=g)
        base = cur.clone()
        # a third of the chunks change, a few words each; the rest are clean
        n_chunks = -(-n // cw)
        for c in range(0, n_chunks, 3):
            lo = c * cw
            base[lo : min(lo + 1000, n)] ^= 0x5A5A5A5A
        got = fused_precodec(cur, base, chunk_words=cw)
        ref = fused_precodec_plain(cur, base, chunk_words=cw)
        torch.cuda.synchronize()
        err = max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1]))
        changed = int((got[1][:, 0] != 0).sum())
        errs[name] = err
        log(f"phase1 fused_precodec {name}: n_words={n} chunk_words={cw} "
            f"dirty_chunks={changed}/{n_chunks} max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"fused_precodec {name} disagrees with its plain version")
        if name == "main":
            ms = time_ms(lambda: fused_precodec(cur, base, chunk_words=cw), reps=20)
            plain = time_ms(lambda: fused_precodec_plain(cur, base, chunk_words=cw), reps=3, warmup=1)
            n_bytes = 12 * n + 12 * n_chunks
            b, by = bound_ms(n_bytes, 12 * n)
            report["fused"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                   n_words=n, n_bytes=n_bytes, timed_runs=20, plain_runs=3)
            log(f"phase1 fused_precodec time: ms={ms} plain_ms={plain} bound_ms={b}")
        del cur, base, got, ref
        torch.cuda.empty_cache()
    report["fused"]["max_abs_err"] = max(errs.values())
    report["fused"]["cases"] = errs


def _tie_block():
    import numpy as np

    b = np.zeros(128, np.float32)
    b[:9] = [127.0, 2.5, -2.5, 126.5, -126.5, 0.5, -0.5, 1.5, -3.5]
    b[9] = np.nextafter(np.float32(0.5), np.float32(0))
    b[10] = -b[9]
    return b


def phase1_quantize(n_main, report):
    import numpy as np
    import torch

    from repro_torch.kernels.quantize.ops import TILE, quantize, quantize_plain

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    ties = torch.from_numpy(np.concatenate([_tie_block(), np.zeros(TILE - 128, np.float32)]))
    clip = torch.randn(TILE, generator=torch.Generator().manual_seed(SEED)) * 100
    clip[::128], clip[1::128] = 127.0 * 1024, -127.0 * 1024
    cases = [
        ("main_f32", lambda: torch.randn(n_main, device="cuda", generator=g)),
        ("bf16", lambda: torch.randn(1 << 26, device="cuda", generator=g).to(torch.bfloat16)),
        ("ties", lambda: ties.cuda()),
        ("zeros", lambda: torch.zeros(2 * TILE, device="cuda")),
        ("clip", lambda: clip.cuda()),
    ]
    errs = {}
    for name, make in cases:
        x = make()
        q, s = quantize(x)
        blocks = x.reshape(-1).float()
        rq, rs = quantize_plain(blocks.view(-1, 128))
        torch.cuda.synchronize()
        err = max(max_abs_err(q, rq), max_abs_err(s, rs))
        errs[name] = err
        log(f"phase1 quantize {name}: n_values={x.numel()} dtype={x.dtype} "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"quantize {name} disagrees with its plain version")
        if name == "ties":
            codes = q[0, :11].tolist()
            assert codes == [127, 3, -3, 127, -127, 1, -1, 2, -4, 1, -1], codes
        if name == "clip":
            assert int(q.max()) == 127 and int(q.min()) == -127
        if name == "main_f32":
            ms = time_ms(lambda: quantize(x), reps=20)
            plain = time_ms(lambda: quantize_plain(blocks.view(-1, 128)), reps=3, warmup=1)
            n = x.numel()
            n_bytes = 4 * n + n + 4 * (n // 128)
            b, by = bound_ms(n_bytes, 8 * n)
            report["quantize"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                      n_values=n, n_bytes=n_bytes, timed_runs=20, plain_runs=3)
            log(f"phase1 quantize time: ms={ms} plain_ms={plain} bound_ms={b}")
        del x, q, s, rq, rs, blocks
        torch.cuda.empty_cache()
    report["quantize"]["max_abs_err"] = max(errs.values())
    report["quantize"]["cases"] = errs


def _check_cases(kernel, cases, report_key, report):
    """Run ``cases`` (name -> thunk returning the error, 0 when equal),
    log each, raise on the first disagreement; record the max error."""
    errs = {}
    for name, run in cases:
        err = run()
        errs[name] = err
        log(f"phase1 {kernel} {name}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{kernel} {name} disagrees with its plain version")
    report[report_key]["max_abs_err"] = max(errs.values())
    report[report_key]["cases"] = errs


def phase1_checksum(n_main, report):
    import torch

    from repro_torch.kernels.checksum.ops import checksum_u32, checksum_u32_plain, digest_array

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda", generator=g)

    def held(w):
        got, ref = checksum_u32(w), checksum_u32_plain(w)
        torch.cuda.synchronize()
        return max_abs_err(got, ref)

    def empty():
        before = checksum_u32.launches
        got = checksum_u32(words(0))
        assert checksum_u32.launches == before and not got.any()
        return max_abs_err(got, checksum_u32_plain(words(0)))

    def unaligned():
        w = words(5_000_003)
        return max(held(w[k : k + 5_000_000]) for k in (1, 2, 3))

    def digest_views():
        # views off a 16-byte boundary; the CPU copy takes the plain path
        x = torch.randn(3_000_001, device="cuda", generator=g)
        err = 0.0
        for v in (x[1:], x[3:], x.to(torch.bfloat16)[1:], x.to(torch.int8)[1:],
                  x.double()[1:], x > 0):
            err = max(err, max_abs_err(digest_array(v).cpu(), digest_array(v.cpu())))
        return err

    w = words(n_main)
    ms = time_ms(lambda: checksum_u32(w), reps=20)
    plain = time_ms(lambda: checksum_u32_plain(w), reps=3, warmup=1)
    n_bytes = 4 * n_main + 8
    b, by = bound_ms(n_bytes, 4 * n_main)
    report["checksum"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                              n_words=n_main, n_bytes=n_bytes, timed_runs=20, plain_runs=3)
    log(f"phase1 checksum_u32 time: ms={ms} plain_ms={plain} bound_ms={b} "
        f"library_ms=None (no single PyTorch call computes the two-track sum)")
    _check_cases("checksum_u32", [
        ("main", lambda: held(w)),
        ("empty", empty),
        ("one_word", lambda: held(words(1))),
        ("ragged_tail", lambda: held(words(1_000_003))),
        ("index_wrap", lambda: held(words(3 * (1 << 20) + 7))),
        ("unaligned_view", unaligned),
        ("digest_array_views", digest_views),
    ], "checksum", report)
    del w
    torch.cuda.empty_cache()


def phase1_delta(n_main, report):
    import torch

    from repro_torch.kernels.delta.ops import xor_delta, xor_delta_plain

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda", generator=g)

    def held(cur, prev, want=None):
        d, c = xor_delta(cur, prev)
        rd, rc = xor_delta_plain(cur, prev)
        torch.cuda.synchronize()
        err = max(max_abs_err(d, rd), abs(int(c) - int(rc)))
        if want is not None and int(c) != want:
            raise AssertionError(f"xor_delta counted {int(c)} changed words, not {want}")
        return err

    cur = words(n_main)                  # n_main % 4 == 2: a ragged tail
    prev = cur.clone()
    prev[::13] ^= 0x5A5A5A5A
    ms = time_ms(lambda: xor_delta(cur, prev), reps=20)
    plain = time_ms(lambda: xor_delta_plain(cur, prev), reps=3, warmup=1)
    n_bytes = 12 * n_main + 8
    b, by = bound_ms(n_bytes, 3 * n_main)
    report["xor_delta"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                               n_words=n_main, n_bytes=n_bytes, timed_runs=20, plain_runs=3)
    log(f"phase1 xor_delta time: ms={ms} plain_ms={plain} bound_ms={b} "
        f"library_ms=None (no single PyTorch call gives the XOR and its count)")
    small = words(4_000_001)
    _check_cases("xor_delta", [
        ("main", lambda: held(cur, prev, want=-(-n_main // 13))),
        ("equal", lambda: held(small, small.clone(), want=0)),
        ("all_changed", lambda: held(small, ~small, want=small.numel())),
        ("ragged_tail", lambda: held(words(1_000_003), words(1_000_003))),
    ], "xor_delta", report)
    del cur, prev, small
    torch.cuda.empty_cache()


def phase1_dequantize(n_main, report):
    import torch

    from repro_torch.kernels.quantize.ops import dequantize, dequantize_plain, quantize

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(n_main, device="cuda", generator=g)
    q, s = quantize(x)
    del x
    torch.cuda.empty_cache()

    def held(q, s, n):
        got, ref = dequantize(q, s, n=n), dequantize_plain(q, s, n=n)
        torch.cuda.synchronize()
        if not same_floats(got, ref):
            return float("inf")
        return max_abs_err(got, ref)

    nb = 1000
    zq, zs = q[:nb].clone(), s[:nb].clone()
    zq[100:400], zs[100:400] = 0, 0.0
    ns = s[:nb].clone()
    ns[[5, 999]] = float("nan")
    ms = time_ms(lambda: dequantize(q, s, n=n_main), reps=20)
    plain = time_ms(lambda: dequantize_plain(q, s, n=n_main), reps=3, warmup=1)
    library = time_ms(lambda: q * s[:, None], reps=20)
    lib_equal = same_floats(dequantize(q, s, n=n_main), (q * s[:, None]).view(-1)[:n_main])
    n_bytes = n_main + 4 * s.numel() + 4 * n_main
    b, by = bound_ms(n_bytes, 2 * n_main)
    report["dequantize"] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                library_ms=library, library_call="q * s[:, None]",
                                library_equal=lib_equal, n_values=n_main, n_bytes=n_bytes,
                                timed_runs=20, plain_runs=3)
    log(f"phase1 dequantize time: ms={ms} plain_ms={plain} bound_ms={b} "
        f"library_ms={library} (q * s[:, None], bit-equal: {lib_equal})")
    _check_cases("dequantize", [
        ("main", lambda: held(q, s, n_main)),
        ("cut_mid_block", lambda: held(q[:nb], s[:nb], nb * 128 - 51)),
        ("cut_first_block", lambda: held(q[:nb], s[:nb], 5)),
        ("zero_blocks", lambda: held(zq, zs, nb * 128)),
        ("nan_scale", lambda: held(q[:nb], ns, nb * 128 - 1)),
    ], "dequantize", report)
    del q, s, zq, zs, ns
    torch.cuda.empty_cache()


# -- phase 2 --------------------------------------------------------------


def manager(root, cluster, **kw):
    from repro_torch.core import CheckpointConfig, CheckpointManager

    return CheckpointManager(CheckpointConfig(
        root=str(root), cluster=cluster, strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=CHUNK_SIZE, device_precodec=True,
        delta_every=4, device=DEVICE, **kw,
    ))


def drop_l1(mgr):
    """Delete the node-local L1 of the 4 saving nodes under ``mgr``'s
    root (a node loss); returns ``mgr``."""
    for n in range(4):
        mgr.local.drop_node(n)
    return mgr


def restore_step(root, step, target):
    from repro_torch.core import theta_like

    mgr = drop_l1(manager(root, theta_like(3, 1)))
    t0 = time.perf_counter()
    got_step, tree = mgr.restore(target, step=step)
    sync()
    secs = time.perf_counter() - t0
    rr = mgr.last_read_result
    mgr.close()
    assert got_step == step
    return tree, secs, rr


def ckpt_chunk_digests(root, step):
    """The device pre-codec's per-chunk digests of ``step`` on the PFS
    under ``root`` (its manifest's chunk table) with its leaf table: the
    chunk count and a SHA-256 over both."""
    import hashlib

    from repro_torch.core.serialize import Manifest

    path = Path(root) / "pfs" / f"step_{step:08d}" / "manifest.json"
    man = Manifest.from_json(path.read_text())
    if man.chunks is None or man.chunks.digest is None:
        raise AssertionError(f"step {step} under {root}: no chunk digests")
    h = hashlib.sha256(man.chunks.digest.tobytes())
    h.update(json.dumps([(l.name, l.dtype, list(l.shape), l.offset, l.size)
                         for l in man.leaves]).encode())
    return {"chunks": len(man.chunks.digest), "sha256": h.hexdigest()}


def check_placed(state, cfg, tcfg, mesh, what):
    """Every leaf of the train state ``state`` a DTensor on ``mesh`` with
    the placements ``train_state_specs`` gives it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import get_model
    from repro_torch.models.sharding import is_spec, to_placements
    from repro_torch.train import train_state_specs
    from repro_torch.utils.treelib import tree_leaves

    specs = tree_leaves(train_state_specs(get_model(cfg), mesh, tcfg), is_leaf=is_spec)
    named = leaves(state)
    if len(named) != len(specs):
        raise AssertionError(f"{what}: {len(named)} leaves for {len(specs)} specs")
    for (name, x), spec in zip(named, specs):
        if not isinstance(x, DTensor) or x.device_mesh is not mesh or \
                tuple(x.placements) != to_placements(spec, mesh):
            raise AssertionError(f"{what}: leaf {name} is not placed by {spec}")


def step_row(st, restore_s, rr):
    fl = st.flush
    return dict(
        step=st.step, stage_s=st.stage_s, stage_wait_s=st.stage_wait_s,
        blocking_window_s=st.encode_time + st.local_time,
        encode_s=st.encode_time, local_s=st.local_time,
        flush_s=fl.duration if fl else None, flush_bytes=fl.bytes_written if fl else None,
        restore_s=restore_s, restore_bytes_read=rr.bytes_read if rr else None,
        raw_bytes=st.raw_bytes, stored_bytes=st.stored_bytes,
        stored_over_raw=st.stored_bytes / st.raw_bytes,
    )


# leaves whose pre-stage device digest is also held against the host
# digest_ref of their host copy
HOST_DIGEST_LEAVES = ("['opt']['count']", "['params']['final_norm']",
                      "['params']['layers']['bq']", "['params']['layers']['wq']",
                      "['step']")


def kernel_counters():
    from repro_torch.kernels import (
        checksum_u32,
        dequantize,
        fused_precodec,
        quantize,
        xor_delta,
    )

    return {"fused_precodec": fused_precodec, "quantize": quantize,
            "checksum": checksum_u32, "xor_delta": xor_delta, "dequantize": dequantize}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def device_digests(tree):
    """(S, T) of every leaf, by ``digest_array`` on the leaf's device,
    as one host array (n_leaves, 2) uint32."""
    import torch

    from repro_torch.kernels.checksum.ops import digest_array
    from repro_torch.kernels.common import u32_numpy

    return u32_numpy(torch.stack([digest_array(t) for _, t in leaves(tree)]))


def check_host_digests(pre, copy, what):
    """The pre-stage device digests of HOST_DIGEST_LEAVES against the
    host oracle over the host copy's bytes."""
    import numpy as np

    from repro_torch.kernels.checksum.ref import checksum_ref_np

    names = [n for n, _ in copy]
    for name in HOST_DIGEST_LEAVES:
        i = names.index(name)
        words = copy[i][1].reshape(-1).numpy().view(np.uint32)
        if tuple(int(v) for v in pre[i]) != checksum_ref_np(words):
            raise AssertionError(f"{what}: device digest of {name} != host digest_ref")


def clone_raw_leaves(qtree):
    """A copy of a quantized tree: its unquantized leaves are the state's
    own tensors, which the in-place train step would change."""
    from repro_torch.utils.treelib import tree_map

    return tree_map(lambda x: x.clone(), qtree)


def phase2(n_layers, tmp, pool, report):
    """The main path. Returns the kernel launches counted over this
    phase."""
    import numpy as np
    import torch

    from repro_torch.core import theta_like
    from repro_torch.core.precodec import (
        _dequantize_leaf,
        _is_float_leaf,
        dequantize_tree_reference,
        quantize_tree,
    )
    from repro_torch.kernels.quantize.ops import TILE, quantize_plain
    from repro_torch.kernels.common import pad_to_multiple

    t0 = time.perf_counter()
    state = make_state(n_layers, DEVICE, pool)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(state))
    log(f"phase2 state: qwen1.5-0.5b n_layers={n_layers} leaves={len(leaves(state))} "
        f"bytes={n_bytes} built_s={time.perf_counter() - t0:.3f}")
    report["state"] = dict(n_layers=n_layers, bytes=n_bytes, leaves=len(leaves(state)))

    reset_counts()

    # -- precodec none: anchor, top-4-layer fine-tune, full update --------
    root = tmp / "none"
    mgr = manager(root, theta_like(4, 4))
    copies, stats, pre = {}, {}, {}
    updates = {1: fine_tune_top_layers, 2: update_everything, 3: None}
    for step in (1, 2, 3):
        copies[step] = host_copy(state)
        pre[step] = device_digests(state)        # pre-D2H integrity, untimed
        check_host_digests(pre[step], copies[step], f"step {step}")
        mgr.stage(step, state)
        if updates[step] is not None:
            updates[step](state)     # the next train step, in place
        stats[step] = mgr.save(step, state)
        st = stats[step]
        log(f"phase2 none step {step}: stage_s={st.stage_s:.4f} "
            f"stage_wait_s={st.stage_wait_s:.4f} "
            f"window_s={st.encode_time + st.local_time:.4f} "
            f"stored/raw={st.stored_bytes / st.raw_bytes:.6f}")
    t_wait = time.perf_counter()
    mgr.wait()
    log(f"phase2 none wait_s={time.perf_counter() - t_wait:.3f}")
    assert not mgr.flush_errors, mgr.flush_errors
    mgr.close()
    rows = []
    for step in (1, 2, 3):
        tree, secs, rr = restore_step(root, step, state)
        same_bytes(leaves(tree), copies[step], f"step {step}")
        post = device_digests(tree)
        if not np.array_equal(post, pre[step]):
            bad = [n for (n, _), a, b in zip(leaves(tree), post, pre[step]) if (a != b).any()]
            raise AssertionError(f"step {step}: restored digests differ for {bad}")
        del tree
        rows.append(step_row(stats[step], secs, rr))
        log("phase2 none " + json.dumps(rows[-1]))
        log(f"phase2 none step {step}: device digests of {len(post)} restored leaves "
            f"equal their pre-stage digests; {len(HOST_DIGEST_LEAVES)} equal the host digest_ref")
    report["steps_none"] = rows
    del copies
    shutil.rmtree(root)

    # -- precodec int8: anchor and one delta ------------------------------
    def expected_int8(state):
        out = []
        for name, t in leaves(state):
            if _is_float_leaf(t):
                q, s = quantize_plain(pad_to_multiple(t.reshape(-1), TILE).view(-1, 128))
                out.append((name, (q.cpu(), s.cpu())))
            else:
                out.append((name, t.detach().to("cpu", copy=True)))
        return out

    root = tmp / "int8"
    mgr = manager(root, theta_like(4, 4), precodec="int8")
    expect, qtrees, stats = {}, {}, {}
    for step in (1, 2):
        expect[step] = expected_int8(state)
        qtrees[step] = clone_raw_leaves(quantize_tree(state))   # kept on the card
        mgr.stage(step, state)
        if step == 1:
            fine_tune_top_layers(state)
        stats[step] = mgr.save(step, state)
    mgr.wait()
    assert not mgr.flush_errors, mgr.flush_errors
    mgr.close()
    rows = []
    for step in (1, 2):
        tree, secs, rr = restore_step(root, step, state)
        spec = dequantize_tree_reference(qtrees.pop(step), tree, device=DEVICE)
        for (name, got), (_, want), (_, ref) in zip(leaves(tree), expect[step], leaves(spec)):
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"int8 step {step}: leaf {name} differs from dequantize_tree_reference"
                )
            if isinstance(want, tuple):
                want = _dequantize_leaf(want[0], want[1], got)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"int8 step {step}: leaf {name} differs")
        del tree, spec
        rows.append(step_row(stats[step], secs, rr))
        log("phase2 int8 " + json.dumps(rows[-1]))
        log(f"phase2 int8 step {step}: restore equals dequantize_tree_reference "
            f"and the plain quantize + host dequantize")
    report["steps_int8"] = rows
    shutil.rmtree(root)

    launches = read_counts()
    log(f"phase2 launches: {launches}")
    for name in ("fused_precodec", "quantize", "checksum", "dequantize"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches


# -- phase 3 --------------------------------------------------------------


def phase3(pool, report):
    """The pre-fusion chain (benchmarks/kernel_bench.py's per-kernel
    pass) on the words of a full-depth train state, held equal to the
    fused pass."""
    import torch

    from repro_torch.core.precodec import DevicePrecodec
    from repro_torch.kernels.checksum.ops import checksum_u32
    from repro_torch.kernels.delta.ops import xor_delta
    from repro_torch.kernels.fused.ops import fused_precodec

    cw = CHUNK_SIZE // 4
    state = make_state(N_LAYERS, DEVICE, pool, seed=SEED + 10)
    pc = DevicePrecodec(chunk_size=CHUNK_SIZE, device=DEVICE)
    _, prev = pc.assemble(state)
    fine_tune_top_layers(state)
    _, cur = pc.assemble(state)
    pc.close()
    n = cur.numel()
    n_chunks = -(-n // cw)
    sync()
    at_start = before_gc = None
    if DEVICE == "cuda":
        # what earlier phases' objects still hold on the card beside this
        # state, before and after a collection of reference cycles
        before_gc = torch.cuda.memory_allocated()
        gc.collect()
        at_start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # what the chain and the fused pass hold at once: the state, two
    # streams, the chain's delta and the fused (chunk-padded) delta
    held = sum(t.numel() * t.element_size() for _, t in leaves(state)) + 12 * n
    held += 4 * n_chunks * cw

    reset_counts()

    def chain():
        delta, count = xor_delta(cur, prev)
        sums = torch.stack([checksum_u32(cur[c * cw : (c + 1) * cw]) for c in range(n_chunks)])
        nz = torch.zeros(n_chunks * cw, dtype=torch.bool, device=cur.device)
        nz[:n] = delta != 0
        dirty = nz.view(n_chunks, cw).sum(dim=1)
        return delta, count, dirty, sums

    def fused():
        return fused_precodec(cur, prev, chunk_words=cw)

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    chain_s, (delta, count, dirty, sums) = wall(chain)
    fused_s, (fdelta, meta) = wall(fused)
    flat = fdelta.view(-1)
    if not torch.equal(flat[:n], delta) or flat[n:].any():
        raise AssertionError("phase3: the chain's delta differs from the fused delta")
    if not torch.equal(meta[:, 0].to(torch.int64), dirty):
        raise AssertionError("phase3: per-chunk dirty counts differ")
    if not torch.equal(meta[:, 1:], sums):
        raise AssertionError("phase3: per-chunk digests differ")
    if int(count) != int(meta[:, 0].to(torch.int64).sum()):
        raise AssertionError("phase3: xor count != sum of the fused dirty counts")
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    n_dirty = int((dirty > 0).sum())
    del delta, count, dirty, sums, fdelta, meta, flat
    launches = read_counts()
    # timed again in turns: chain, fused, fused, chain
    times = {"chain": [chain_s], "fused": [fused_s]}
    for name in ("chain", "fused", "fused", "chain"):
        secs, out = wall(chain if name == "chain" else fused)
        times[name].append(secs)
        del out
    report["phase3"] = dict(n_words=n, n_chunks=n_chunks, dirty_chunks=n_dirty,
                            chain_s=times["chain"], fused_s=times["fused"],
                            allocated_before_gc_bytes=before_gc,
                            allocated_at_start_bytes=at_start, peak_device_bytes=peak,
                            state_streams_deltas_bytes=held, launches=launches)
    log(f"phase3 chain equals fused: n_words={n} chunks={n_chunks} dirty_chunks={n_dirty} "
        f"checksum_launches={launches['checksum']}")
    log(f"phase3 wall_s chain={times['chain']} fused={times['fused']} "
        f"(first of each checked; then chain, fused, fused, chain)")
    log(f"phase3 device memory: peak_bytes={peak} allocated_before_gc_bytes={before_gc} "
        f"allocated_at_start_bytes={at_start} "
        f"state_two_streams_two_deltas_bytes={held}")
    for name in ("xor_delta", "checksum", "fused_precodec"):
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched in phase 3")
    del prev, cur, state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return launches


# kernel classes of a train step, by the first pattern a kernel's name matches
KERNEL_CLASSES = [
    ("matmul_f32", r"gemm_f32f32"),
    ("matmul", r"gemm|xmma|nvjet|cutlass|cublas"),
    ("softmax", r"softmax"),
    ("copy_cast", r"copy"),
    ("reduce", r"reduce"),
    ("index", r"index|scatter|gather|sort|radix"),
    ("elementwise", r"elementwise"),
]


def profile_train_step(cfg, tcfg, state, data, tag="phase4"):
    """One more train step on ``state`` under :func:`profile_device`."""
    from repro_torch.models import get_model
    from repro_torch.train import build_train_step

    step = build_train_step(get_model(cfg), tcfg)
    batch = data.next()
    return profile_device(lambda: step(state, batch), tag, "one clean step")


def profile_device(fn, tag, what):
    """``fn()`` once under ``torch.profiler``, tracing the device's
    activity only (no host-side op records): the device time of each
    kernel and of each class of ``KERNEL_CLASSES``, and the kernels'
    union over the span (busy share), with the profiled call's wall time
    to hold against a clean call's. Without device events in the trace,
    nothing is measured."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if DEVICE == "cuda" else [ProfilerActivity.CPU]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    out = {"wall_s": wall, "n_kernels": len(spans)}
    if not spans:
        log(f"{tag} profile: wall_s={wall:.4f}; no device events in the trace (not measured)")
        return out
    busy, end = 0.0, spans[0][0]
    totals = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        t, n = totals.get(name, (0.0, 0))
        totals[name] = (t + b - a, n + 1)
    span = end - spans[0][0]
    classes = {}
    for name, (t, _) in totals.items():
        cls = next((c for c, pat in KERNEL_CLASSES if re.search(pat, name, re.I)), "other")
        classes[cls] = classes.get(cls, 0.0) + t / 1e3
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:12]
    out.update(device_span_ms=span / 1e3, busy_ms=busy / 1e3, busy_share=busy / span,
               class_ms=classes, top=[(n, t / 1e3, c) for n, (t, c) in top])
    log(f"{tag} profile ({what}, device trace on): wall_s={wall:.4f} kernels={len(spans)} "
        f"device_span_ms={span / 1e3:.3f} busy_ms={busy / 1e3:.3f} busy_share={busy / span:.4f}")
    log(f"{tag} profile kernel classes ms: "
        + " ".join(f"{c}={t:.3f}" for c, t in sorted(classes.items(), key=lambda kv: -kv[1])))
    for name, t, c in out["top"]:
        log(f"{tag} profile kernel ms={t:.3f} launches={c} {name[:110]}")
    return out


# -- phase 4 --------------------------------------------------------------

# one step at the main path's widths on the card against the port's CPU
# step: bf16 compute rounds each matmul's output to 8 bits of mantissa
# (2^-8 = 0.0039) in a different order on each side, so each leaf's
# gradient (mu = (1 - beta1) * clipped g) may differ by a few of those
# in norm; a wrong gradient (remat, the query chunks, the embedding's
# scatter-add) is off by far more. The MoE aux loss: the router reads the
# bf16-rounded FFN input (in float32), so its probabilities differ by
# about 2^-8 relative, and each moved slot shifts 1/(B*S) of one expert's
# density: 1e-2 relative.
REF_STEP_TOL = {"loss": 1e-3, "aux": 1e-2, "grad_norm": 2e-2, "mu": 2e-2, "update_norm": 2e-2}
# the most that a router logit may trail the CPU's k-th largest where the
# card chose that expert and the CPU did not (a flipped slot): bf16
# rounding of the FFN input moves a logit of unit scale by about 2.5e-3;
# a wrong selection trails by order 1
ROUTER_TIE_TOL = 0.05
# the routed experts' leaves (and the router's): their mu is held to
# REF_STEP_TOL["mu"] plus what the moved slots account for
ROUTED_LEAVES = ("['router']", "['w_gate']", "['w_up']", "['w_down']")


@contextmanager
def moe_probe():
    """While on, record each MoE FFN call's routing (the router logits,
    ``sel`` and ``keep``, on the host) and aux loss; yields the two lists.
    Under remat, backward's recomputation records again (the routing, and
    the aux loss where the recomputation runs that far): a step's first
    records are its forward's."""
    from repro_torch.models import moe, transformer

    routes, auxes = [], []
    route, ffn = moe.route, transformer.moe_ffn

    def recording_route(logits, m, c):
        out = route(logits, m, c)
        routes.append((logits.detach().float().cpu(), out[0].cpu(), out[2].cpu()))
        return out

    def recording_ffn(x, p, m):
        out, aux = ffn(x, p, m)
        auxes.append(float(aux.detach()))
        return out, aux

    moe.route, transformer.moe_ffn = recording_route, recording_ffn
    try:
        yield routes, auxes
    finally:
        moe.route, transformer.moe_ffn = route, ffn


def route_diff(card, cpu):
    """The card's routing against the CPU's, call by call: slots, kept
    slots (CPU), flipped slots (an expert the card chose and the CPU did
    not), slots whose drop was decided the other way, the largest gap by
    which a flipped expert's CPU logit trails the CPU's k-th largest, and
    per call a (B, S) mask of the tokens routed otherwise."""
    import torch

    r = dict(slots=0, kept=0, flipped=0, keep_diff=0, max_gap=0.0)
    differ = []
    for (_, g_sel, g_keep), (logits, c_sel, c_keep) in zip(card, cpu):
        def table(sel, keep):      # 1: chosen and kept, 2: chosen and dropped
            t = torch.zeros(logits.shape, dtype=torch.int8)
            return t.scatter_(-1, sel, torch.where(keep, 1, 2).to(torch.int8))

        tg, tc = table(g_sel, g_keep), table(c_sel, c_keep)
        moved = (tg > 0) & (tc == 0)
        r["slots"] += c_sel.numel()
        r["kept"] += int(c_keep.sum())
        r["flipped"] += int(moved.sum())
        r["keep_diff"] += int(((tg > 0) & (tc > 0) & (tg != tc)).sum())
        if moved.any():
            kth = logits.gather(-1, c_sel).min(-1, keepdim=True).values
            r["max_gap"] = max(r["max_gap"], float((kth - logits)[moved].max()))
        differ.append((tg != tc).any(-1))
    return r, differ


def moved_slots_tol(r):
    """Each moved slot (flipped, or dropped on one side only) moves one
    token's share of a routed expert's gradient, and of the router's, to
    another: about sqrt(2 * moved / kept) of a leaf summed over the kept
    slots' roughly independent shares. Twice that is allowed."""
    return 2 * math.sqrt(2 * (r["flipped"] + r["keep_diff"]) / max(r["kept"], 1))


def phase4_reference_step(cfg, tcfg, seq_len, report, *, n_layers=2, global_batch=2,
                          tag="phase4"):
    """One train step of ``cfg`` at its full widths and ``seq_len`` (text
    tokens; a VLM batch's patches come first, an audio batch's frames go
    to the encoder), depth cut to ``n_layers`` (an encoder's too),
    from the same state (from a seed) on the same batch, on the card and
    on the CPU through the port's own step: loss and grad_norm, and per
    leaf mu and the update's norm, within ``REF_STEP_TOL`` (relative); lr
    equal. For a MoE model also the aux loss, and the router's
    selections: every flipped slot must be a near tie (``ROUTER_TIE_TOL``),
    and the routed experts' and the router's mu are held to
    ``REF_STEP_TOL["mu"]`` plus :func:`moved_slots_tol`. The card's state
    stays on the card; leaves are compared there one at a time."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.train import build_train_step
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.convert import copy_tree_

    cfg = cut_depth(cfg, n_layers)
    model = get_model(cfg)

    def state(params, dev):
        return {"params": params, "opt": init_opt_state(params, tcfg.opt),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    # drawn on the card (the CPU's draws of a state of 0.3-1.2 G parameters
    # took seconds to tens of seconds), then copied to the CPU
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE).state_tree()
    card_state = state(params, DEVICE)
    cpu_state = state(copy_tree_(model.build("cpu").state_tree(), params), "cpu")
    start = [p.detach().clone() for _, p in leaves(params)]
    batch = SyntheticTokens(data_config(cfg, seq_len, global_batch), device="cpu").next()
    step = build_train_step(model, tcfg)
    out = {}
    for dev, state in ((DEVICE, card_state), ("cpu", cpu_state)):
        with moe_probe() as (routes, auxes):
            sync()
            t0 = time.perf_counter()
            _, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            metrics = {k: float(v) for k, v in m.items()}
            secs = time.perf_counter() - t0
        if cfg.moe is not None:
            metrics["aux"] = sum(auxes[:n_layers])      # the forward's calls
        out[dev] = (metrics, secs, routes[:n_layers])
    (gm, g_s, g_routes), (cm, c_s, c_routes) = out[DEVICE], out["cpu"]

    def rel(x, y):
        return float((x - y).norm() / max(float(y.norm()), 1e-30))

    tol = dict(REF_STEP_TOL)
    keys = ("loss", "grad_norm") + (("aux",) if cfg.moe is not None else ())
    err = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in keys}
    routing = None
    if cfg.moe is not None:
        routing, _ = route_diff(g_routes, c_routes)
        tol["mu_routed"] = tol["mu"] + moved_slots_tol(routing)
    mu, upd = {}, {}
    with torch.no_grad():
        for (n, x), (_, y), x0 in zip(leaves(card_state["params"]),
                                      leaves(cpu_state["params"]), start):
            x0 = x0.double()
            nx = float((x.double() - x0).norm())
            ny = float((y.to(DEVICE).double() - x0).norm())
            upd[n] = abs(nx - ny) / ny
        for (n, x), (_, y) in zip(leaves(card_state["opt"]["mu"]),
                                  leaves(cpu_state["opt"]["mu"])):
            mu[n] = rel(x.double(), y.to(DEVICE).double())
    routed = {n for n in mu if "['moe']" in n and n.endswith(ROUTED_LEAVES)}
    err["mu"] = max(v for n, v in mu.items() if n not in routed)
    if routed:
        err["mu_routed"] = max(mu[n] for n in routed)
    err["update_norm"] = max(upd.values())
    del card_state, cpu_state, params, start
    row = dict(n_layers=n_layers, batch=global_batch, seq_len=seq_len, metrics=gm,
               cpu_metrics=cm, step_s=g_s, cpu_step_s=c_s, err=err, tol=tol,
               mu_rel=mu, update_norm_rel=upd, routing=routing)
    report[f"{tag}_reference_step".replace(" ", "_")] = row
    log(f"{tag} reference step ({cfg.name} widths, {depth(cfg)} layers, batch "
        f"{global_batch}x{seq_len}): card {gm} in {g_s:.3f} s, cpu {cm} in {c_s:.3f} s")
    if routing is not None:
        log(f"{tag} reference step routing, card against cpu: {routing['flipped']} of "
            f"{routing['slots']} (token, k) selections differ (largest gap "
            f"{routing['max_gap']:.3e}, tol {ROUTER_TIE_TOL:g}); {routing['keep_diff']} slots "
            f"dropped on one side only; {routing['kept']} kept (cpu)")
    log(f"{tag} reference step relative errors: "
        + " ".join(f"{k}={v:.3e} (tol {tol[k]:.3g})" for k, v in err.items())
        + f"; worst mu leaf {max(mu, key=mu.get)}")
    bad = {k: v for k, v in err.items() if not v <= tol[k]}
    if routing is not None and not routing["max_gap"] <= ROUTER_TIE_TOL:
        bad["router_gap"] = routing["max_gap"]
    if bad or abs(gm["lr"] - cm["lr"]) > 1e-6 * cm["lr"]:
        raise AssertionError(f"{tag}: the card's step differs from the CPU's: {bad}, "
                             f"lr {gm['lr']} vs {cm['lr']}")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return row


def train_and_replay(cfg, root, report, tag, *, seq_len, global_batch, steps, ckpt_every,
                     save_last=True, ckpt_kw=None, around_a=None, log_a=None, keep_a=False,
                     tcfg=None, mesh=None):
    """The trainer (``run``) on ``cfg`` at batch ``global_batch`` x
    ``seq_len`` under ``root``: run A trains steps 1..``steps`` with a
    device pre-codec save every ``ckpt_every`` steps and, with
    ``save_last``, at the last (each staged on the card after its step
    and saved after the next); run B, a fresh model, pipeline and manager
    on the same root, restores the last save before step ``steps`` from
    the PFS with L1 dropped and replays the steps after it. Every loss of
    run A must be finite, and run B's losses and state (params, mu, nu,
    count, step) must equal run A's byte for byte, device digest for
    digest and cursor for cursor. ``around_a(go)`` runs ``go()``, run A,
    inside the caller's context; ``log_a`` sees each of run A's log
    lines. Returns a dict: run A's ``losses``, ``step_s``, ``saves``
    (``SaveStats``), ``peak`` device bytes and ``run_a_s``, its leaves'
    ``names``, ``digests`` and data ``cursor`` (with ``keep_a`` also its
    state's leaves, ``state_a``); ``b``, run B's ``TrainRun``,
    ``run_b_s`` and ``resume``, the step it restored; the kernel
    ``launches`` over both runs. ``tcfg``: the runs' ``TrainConfig``
    (default lr 3e-4 over ``steps``). With a ``mesh`` both runs place
    their state on it (``run(..., mesh=)``) and every leaf of both must be
    a DTensor laid out by ``train_state_specs``; the comparisons read
    the whole tensors."""
    import numpy as np
    import torch

    from repro_torch.core import CheckpointConfig, theta_like
    from repro_torch.launch.train import run
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.utils.convert import whole_tensor
    from repro_torch.utils.treelib import tree_map

    data_cfg = data_config(cfg, seq_len, global_batch)
    tcfg = tcfg or TrainConfig(opt=OptConfig(lr=3e-4, total_steps=steps), remat=True)
    ckpt = CheckpointConfig(
        root=str(root), cluster=theta_like(4, 4), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=CHUNK_SIZE, device_precodec=True,
        precodec="none", device=DEVICE, **(ckpt_kw or {}),
    )
    resume = (steps - 1) // ckpt_every * ckpt_every
    gc.collect()
    reset_counts()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def line_a(line):
        if log_a is not None:
            log_a(line)
        log(f"{tag} A {line}")

    def run_a():
        return run(cfg, data_cfg, tcfg, ckpt, steps=steps, ckpt_every=ckpt_every,
                   device=DEVICE, seed=SEED, log=line_a, save_last=save_last, mesh=mesh)

    def whole(state, what):
        if mesh is not None:
            check_placed(state, cfg, tcfg, mesh, what)
        return tree_map(whole_tensor, state)

    t0 = time.perf_counter()
    a = around_a(run_a) if around_a else run_a()
    out = dict(run_a_s=time.perf_counter() - t0, resume=resume,
               peak=torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None)
    if a.flush_errors or not np.isfinite(a.losses).all():
        raise AssertionError(f"{tag}: flush errors {a.flush_errors}, losses {a.losses}")
    if read_counts()["fused_precodec"] == 0:
        raise AssertionError(f"{tag}: fused_precodec was not launched on the trainer's saves")
    # run A's state stays on the card for the comparison with run B's
    a.state = whole(a.state, f"{tag} run A")
    state_a = leaves(a.state)
    out.update(names=[n for n, _ in state_a], digests=device_digests(a.state),
               cursor=int(a.data.state_tree()["batch_idx"]), losses=a.losses,
               step_s=a.step_s, saves=a.saves)
    del a
    gc.collect()
    release_host_cache(f"after {tag}'s run A")

    drop_l1(manager(root, theta_like(4, 4))).close()
    t0 = time.perf_counter()
    b = run(cfg, data_cfg, tcfg, ckpt, steps=steps, ckpt_every=0, resume=resume,
            device=DEVICE, seed=SEED + 1, log=lambda line: log(f"{tag} B {line}"), mesh=mesh)
    out.update(b=b, run_b_s=time.perf_counter() - t0)
    b.state = whole(b.state, f"{tag} run B")
    losses_a = out["losses"]
    if b.restored_step != resume or \
            np.asarray(b.losses).tobytes() != np.asarray(losses_a[resume:]).tobytes():
        raise AssertionError(f"{tag} replay: restored {b.restored_step}, losses {b.losses} "
                             f"!= {losses_a[resume:]}")
    if b.restore_read is None or b.restore_read.bytes_read == 0:
        raise AssertionError(f"{tag}: run B did not restore step {resume} from the PFS")
    same_bytes(leaves(b.state), state_a, f"{tag} replayed step {steps}")
    if not np.array_equal(device_digests(b.state), out["digests"]):
        raise AssertionError(f"{tag}: digests of the replayed step {steps} differ")
    if int(b.data.state_tree()["batch_idx"]) != out["cursor"]:
        raise AssertionError(f"{tag}: the replay ends at another batch cursor")
    out["launches"] = read_counts()
    if keep_a:
        out["state_a"] = state_a
    del state_a
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    card = report.get("card")
    for st in out["saves"]:
        fl = st.flush
        log(f"{tag} save step {st.step}: stage_s={st.stage_s:.4f} "
            f"stage_wait_s={st.stage_wait_s:.4f} "
            f"window_s={st.encode_time + st.local_time:.4f} "
            f"flush_s={fl.duration if fl else None} "
            f"flush_bytes={fl.bytes_written if fl else None} "
            f"stored/raw={st.stored_bytes / st.raw_bytes:.6f} [{card}]")
    log(f"{tag} losses {losses_a}; restore_s: step {resume} into run B={b.restore_s:.3f} "
        f"({b.restore_read.bytes_read} bytes from the PFS); run A {out['run_a_s']:.1f} s, "
        f"run B {out['run_b_s']:.1f} s [{card}]")
    replayed = f"step {steps}" if resume + 1 == steps else f"steps {resume + 1}-{steps}"
    log(f"{tag} run B's {replayed} equal run A's byte for byte (losses; params, mu, nu, "
        f"count, step), device digest for digest, cursor for cursor")
    return out


def phase4(tmp, report, *, model_cfg=None, seq_len=2048, global_batch=4):
    """The port's trainer at qwen1.5-0.5b's full width (``model_cfg``'s
    depth; ``main`` passes ``PHASE4_LAYERS``, the default is all 24)
    through :func:`train_and_replay`: run A trains steps 1-4 with a device
    pre-codec save every 2 steps (the fused pass runs on the trainer's own
    saves); run B restores step 2 from the PFS with L1 dropped and replays
    steps 3-4 byte for byte. Step 4 restored from the PFS must equal run
    A's too. Before run A, one step at the same widths and sequence length
    (two layers) is held against the port's CPU step. Returns the kernel
    launches counted over both runs, and the device digests of run A's
    step-4 params (phase 5 holds the served params to them)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("qwen1.5-0.5b")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4), remat=True)
    root = tmp / "train"
    log(f"phase4 model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={cfg.param_dtype} "
        f"compute={cfg.compute_dtype} batch={global_batch}x{seq_len} remat=True")

    ref = phase4_reference_step(cfg, tcfg, seq_len, report)
    tr = train_and_replay(cfg, root, report, "phase4", seq_len=seq_len,
                          global_batch=global_batch, steps=4, ckpt_every=2, keep_a=True)
    b, digests = tr.pop("b"), tr["digests"]
    params_digests = digests[[n.startswith("['params']") for n in tr["names"]]]
    step2_chunks = ckpt_chunk_digests(root, 2)      # phase 10 saves the same state

    # step 4 from the PFS, elastic 16 -> 3 ranks, L1 of all 4 saving nodes dropped
    tree, restore4_s, _ = restore_step(root, 4, meta_train_target(cfg))
    same_bytes(leaves(tree["train"]), tr.pop("state_a"), "phase4 restored step 4")
    if not np.array_equal(device_digests(tree["train"]), digests):
        raise AssertionError("phase4: digests of the restored step 4 differ")
    if int(tree["data"]["batch_idx"]) != tr["cursor"]:
        raise AssertionError("phase4: restored step 4 has another batch cursor")
    del tree
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    losses_a, step_s, saves, peak = tr["losses"], tr["step_s"], tr["saves"], tr["peak"]
    run_a_s, run_b_s = tr["run_a_s"], tr["run_b_s"]
    restore2_s, replay_s = b.restore_s, b.step_s
    with deterministic_algorithms():
        profile = profile_train_step(cfg, tcfg, b.state, b.data)
    del b, tr
    launches = read_counts()

    # run A's steps 2-4 share the host with the checkpoint (the stage's
    # pinned copy, the save's encode, the async flush); run B's replayed
    # steps 3-4 run with no checkpoint traffic
    ms = 1e3 * sum(step_s[1:]) / len(step_s[1:])
    replay_ms = 1e3 * sum(replay_s) / len(replay_s)
    tokens = global_batch * seq_len
    row = dict(
        model=cfg.name, n_layers=cfg.n_layers, batch=global_batch, seq_len=seq_len,
        losses=losses_a, step_s=step_s, step_ms_2_to_4=ms, tokens_per_s=tokens / ms * 1e3,
        replay_step_s=replay_s, replay_step_ms=replay_ms,
        replay_tokens_per_s=tokens / replay_ms * 1e3,
        peak_device_bytes=peak, run_a_s=run_a_s, run_b_s=run_b_s,
        restore_step4_s=restore4_s, restore_step2_s=restore2_s,
        saves=[step_row(st, None, None) for st in saves], launches=launches,
        profile=profile, reference_step_err=ref["err"], step2_chunk_digests=step2_chunks,
    )
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase4"] = row
    log(f"phase4 step_ms (run A steps 2-4, synchronised, checkpoint in flight)={ms:.3f} "
        f"tokens_per_s={row['tokens_per_s']:.1f}; replay step_ms (run B steps 3-4, no "
        f"checkpoint)={replay_ms:.3f} tokens_per_s={row['replay_tokens_per_s']:.1f}; "
        f"peak_device_bytes={peak} [{report.get('card')}]")
    log(f"phase4 restore_s: step 4 (check)={restore4_s:.3f}, equal to run A's byte for "
        f"byte; wall {row['wall_s']:.1f} s [{report.get('card')}]")
    if "busy_share" in profile:
        log(f"phase4 profiled step wall {profile['wall_s'] * 1e3:.3f} ms against the clean "
            f"replayed steps' {replay_ms:.3f} ms; device busy {profile['busy_ms']:.3f} of "
            f"{profile['device_span_ms']:.3f} ms ({profile['busy_share']:.4f}) "
            f"[{report.get('card')}]")
    log(f"phase4 launches: {launches}")
    return launches, params_digests


# -- phase 5 --------------------------------------------------------------

# the serving path at the main path's widths on the card against the
# port's CPU (bf16 compute, two layers): each matmul output, the
# embedding cast and the cache are rounded to 8 bits of mantissa
# (2^-8 relative) in another order on each side. Logits of each step
# within 4 such roundings of the step's largest logit (the tolerance of
# tests/test_torch_models.py::test_bf16_compute_matches_reference); the
# cache's k and v within 2 of them in norm, relative. A wrong position,
# mask or cache write is off by far more.
SERVE_REF_TOL = {"logits": 4 * 2.0 ** -8, "cache": 2 * 2.0 ** -8}
# the same in float32 compute: the xLSTM's mLSTM divides by a normaliser
# that can be small, so its bf16 logits move by 1-3 % of their largest
# between two orders of rounding (prefill and decode against a forward
# on the CPU: 2.6e-2 at xlstm-350m's widths) where the transformer's move
# by 0.8 %; in float32 the two agree to 8.5e-6 there, and a wrong state
# handoff is off by far more than 1e-4
SERVE_REF_TOL_F32 = {"logits": 1e-4, "cache": 1e-4}
# the node-local decoded-chunk cache of phase 5's fleet: step 2's and
# step 4's decoded params chunks (2 x 2.48 GB), so the cold start's second
# replica and the swap onto step 4 (a delta on step 2) can hit it
SERVE_CACHE_BYTES = 6 << 30
SWAP_DEADLINE_S = 300.0


# the most steps of phase5_reference's teacher-forced serving that a MoE
# model may route otherwise on the two sides (a near tie flipped, or a
# drop decided the other way, for a token whose logits are held)
SERVE_ROUTED_OTHERWISE_MAX = 0.25


def phase5_reference(cfg, report, *, n_layers=2, batch=2, prompt=2048, steps=16, params=None,
                     tag="phase5", tol=SERVE_REF_TOL):
    """Prefill of ``batch`` x ``prompt`` tokens (a VLM's patch embeddings,
    from a seed, first; an audio model's frames, from the seed, to its
    encoder) then ``steps`` greedy decode steps of ``cfg`` at its full
    widths, depth cut to ``n_layers`` (an encoder's too), from one set of
    weights
    (``params``, a tree of tensors on any device, or else drawn from a
    seed), on the card and through the port's CPU, the CPU teacher-forced
    on the card's tokens: every step's logits and the cache's float leaves
    after prefill and at the end within ``tol`` (``SERVE_REF_TOL``). For a MoE model, a step
    whose held token (prefill: each row's last; decode: each row's) was
    routed otherwise on the two sides is reported and not held; every
    flipped slot must be a near tie (``ROUTER_TIE_TOL``), and at most
    ``SERVE_ROUTED_OTHERWISE_MAX`` of the steps may be routed otherwise."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.utils.treelib import tree_map

    cfg = cut_depth(cfg, n_layers)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE).state_tree()
    r = np.random.default_rng(SEED)
    prompt_np = r.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    inputs = {"tokens": torch.as_tensor(prompt_np)}
    if cfg.family == "vlm":
        inputs["patches"] = torch.as_tensor(
            r.standard_normal((batch, cfg.n_patches, cfg.d_model), dtype=np.float32))
    if cfg.family == "audio":
        inputs["frames"] = torch.as_tensor(
            r.standard_normal((batch, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    s_max = cfg.n_patches * (cfg.family == "vlm") + prompt + steps
    forced = None
    out = {}
    for dev in (DEVICE, "cpu"):
        dev_params = tree_map(lambda x: x.detach().to(dev), params)
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode(), moe_probe() as (routes, _):
            cache, lg = model.prefill(dev_params, {k: v.to(dev) for k, v in inputs.items()},
                                      s_max=s_max)
            logits, caches, toks = [lg.float().cpu()], [float_leaves(cache)], []
            for i in range(steps):
                tok = lg.argmax(-1)[:, None].to(torch.int32) if forced is None else \
                    forced[i].to(dev)
                toks.append(tok.cpu())
                lg, cache = model.decode_step(dev_params, cache, tok)
                logits.append(lg.float().cpu())
            caches.append(float_leaves(cache))
        sync()
        out[dev] = (logits, caches, time.perf_counter() - t0, routes)
        forced = toks       # the CPU decodes the card's tokens
        del dev_params, cache
    (g_logits, g_caches, g_s, g_routes), (c_logits, c_caches, c_s, c_routes) = \
        out[DEVICE], out["cpu"]
    logit_err = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_logits, c_logits)]
    cache_err = [float((a - b).norm() / b.norm())
                 for ga, ca in zip(g_caches, c_caches) for a, b in zip(ga, ca)]
    held = list(range(len(logit_err)))
    routing = None
    if cfg.moe is not None:
        routing, differ = route_diff(g_routes, c_routes)
        # step i's calls: one a layer; its held tokens are the last of
        # each row, and every token of an earlier layer feeds them
        per_step = [differ[i * n_layers:(i + 1) * n_layers] for i in range(steps + 1)]
        otherwise = [i for i, d in enumerate(per_step)
                     if any(bool(x.any()) for x in d[:-1]) or bool(d[-1][:, -1].any())]
        held = [i for i in held if i not in otherwise]
        routing.update(steps_routed_otherwise=otherwise,
                       their_logits_err=[logit_err[i] for i in otherwise])
    worst = max(logit_err[i] for i in held)
    row = dict(n_layers=n_layers, batch=batch, prompt=prompt, steps=steps, card_s=g_s,
               cpu_s=c_s, logits_err=logit_err, cache_err=cache_err, tol=tol,
               held_steps=held, routing=routing)
    report[f"{tag}_reference".replace(" ", "_")] = row
    log(f"{tag} reference ({cfg.name} widths, {depth(cfg)} layers, batch {batch}x{prompt}, "
        f"{steps} decode steps teacher-forced): card {g_s:.3f} s, cpu {c_s:.3f} s; "
        f"worst logits err {worst:.3e} of max|logit| over {len(held)} held steps "
        f"(tol {tol['logits']:g}), worst cache err {max(cache_err):.3e} relative "
        f"(tol {tol['cache']:g})")
    bad = worst > tol["logits"] or max(cache_err) > tol["cache"]
    if routing is not None:
        log(f"{tag} reference routing, card against cpu: {routing['flipped']} of "
            f"{routing['slots']} (token, k) selections differ (largest gap "
            f"{routing['max_gap']:.3e}, tol {ROUTER_TIE_TOL:g}); {routing['keep_diff']} slots "
            f"dropped on one side only; steps routed otherwise for a held token "
            f"{routing['steps_routed_otherwise']} (not held; logits err "
            f"{[round(e, 4) for e in routing['their_logits_err']]})")
        bad = bad or not routing["max_gap"] <= ROUTER_TIE_TOL or \
            len(routing["steps_routed_otherwise"]) > SERVE_ROUTED_OTHERWISE_MAX * (steps + 1)
    if bad:
        raise AssertionError(f"{tag}: the card's serving differs from the CPU's: "
                             f"logits {logit_err}, cache {cache_err}, routing {routing}")
    return row


def float_leaves(cache):
    """A cache's floating-point leaves (a ``DecodeCache``'s k and v, a
    recurrent state's carries and ring buffers) as float32 host copies."""
    return [x.float().cpu() for _, x in leaves(cache) if x.is_floating_point()]


def meta_train_target(cfg):
    """The structure of the trainer's checkpoint (train state + data
    cursor) on the meta device: a restore reads names, not values."""
    import torch

    from repro_torch.models import get_model

    def params():
        return get_model(cfg).param_struct()

    def zero():
        return torch.zeros((), dtype=torch.int32, device="meta")

    return {"train": {"params": params(), "opt": {"mu": params(), "nu": params(),
                                                  "count": zero()}, "step": zero()},
            "data": {"batch_idx": zero()}}


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` by CUDA events (after one warm-up);
    None without a card."""
    if DEVICE != "cuda":
        return None
    return time_ms(fn, reps=reps, warmup=1)


def serve_snapshot(srv, root, report, tag, *, inputs, want, s_max):
    """A serving snapshot and its resume on ``srv`` (a ``Server``):
    prefill of the batch ``inputs`` (on the card: ``tokens``, and an audio
    model's ``frames``) and half of ``want``'s greedy tokens decoded step
    by step, each timed
    and each token equal to ``want``'s (``Server.generate``'s); then the
    snapshot (params, the cache or recurrent state, the next token) saved
    with the device pre-codec under ``root`` and restored from the PFS (L1
    dropped, another geometry) from the model's meta templates into a
    fresh server. The restored cache must equal the saved one digest for
    digest (whisper's cross K/V included: nothing encodes the frames
    again), and the fresh server must emit the other half of ``want``
    identically. Returns the snapshot's row (with ``prefill_ms`` and
    ``decode_ms_per_token``) and the kernel launches of the save and the
    restore."""
    import numpy as np
    import torch

    from repro_torch.core import theta_like
    from repro_torch.serve import Server

    model, batch, new = srv.model, inputs["tokens"].shape[0], want.shape[1]
    half = new // 2
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        cache, lg = model.prefill(srv.params, inputs, s_max=s_max)
        sync()
        prefill_s = time.perf_counter() - t0
        tok, first = lg.argmax(-1)[:, None].to(torch.int32), []
        t0 = time.perf_counter()
        for _ in range(half):
            first.append(tok[:, 0])
            lg, cache = model.decode_step(srv.params, cache, tok)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
        sync()
        decode_ms = 1e3 * (time.perf_counter() - t0) / half
    if not np.array_equal(torch.stack(first, 1).cpu().numpy(), want[:, :half]):
        raise AssertionError(f"{tag}: the decode loop differs from Server.generate")
    cache_type = type(cache)
    before = read_counts()
    cache_digests = device_digests(cache)
    smgr = manager(root, theta_like(4, 4))
    st = smgr.save(1, srv.snapshot_state(cache) | {"tok": tok})
    smgr.wait()
    if smgr.flush_errors or read_counts()["fused_precodec"] == before["fused_precodec"]:
        raise AssertionError(f"{tag} snapshot: flush errors {smgr.flush_errors} or no "
                             f"fused_precodec launch")
    smgr.close()
    del cache, tok
    target = {"params": model.param_struct(), "cache": model.cache_struct(batch, s_max),
              "tok": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
    rmgr = drop_l1(manager(root, theta_like(2, 1)))
    t0 = time.perf_counter()
    _, got = rmgr.restore(target)
    sync()
    restore_s = time.perf_counter() - t0
    rmgr.close()
    if type(got["cache"]) is not cache_type or \
            {x.device.type for _, x in leaves(got)} != {torch.device(DEVICE).type}:
        raise AssertionError(f"{tag}: the restored snapshot is not a {cache_type.__name__} "
                             f"on the card")
    if not np.array_equal(device_digests(got["cache"]), cache_digests):
        raise AssertionError(f"{tag}: the restored cache differs from the saved one")
    fresh = Server(model, got["params"], srv.cfg)
    cache, tok, rest = got["cache"], got["tok"], []
    with torch.inference_mode():
        for _ in range(new - half):
            rest.append(tok[:, 0])
            lg, cache = model.decode_step(fresh.params, cache, tok)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
    if not np.array_equal(torch.stack(rest, 1).cpu().numpy(), want[:, half:]):
        raise AssertionError(f"{tag}: the resumed server emitted other tokens")
    launches = {k: v - before[k] for k, v in read_counts().items()}
    del got, cache, fresh
    fl = st.flush
    row = dict(after=half, stage_s=st.stage_s, window_s=st.encode_time + st.local_time,
               flush_s=fl.duration if fl else None, restore_s=restore_s,
               raw_bytes=st.raw_bytes, stored_bytes=st.stored_bytes,
               prefill_ms=1e3 * prefill_s, decode_ms_per_token=decode_ms)
    log(f"{tag} snapshot after {half} tokens ({st.raw_bytes} bytes): stage_s={st.stage_s:.4f} "
        f"window_s={row['window_s']:.4f} flush_s={row['flush_s']} restore_s={restore_s:.3f}; "
        f"the fresh server emits the other {new - half} tokens identically "
        f"[{report.get('card')}]")
    return row, launches


def phase5(tmp, report, step4_digests, *, model_cfg=None, batch=8, prompt=2048, new=64,
           ref_kw=None):
    """Serving the trainer's checkpoints: phase 4's run A flushed steps 2
    (anchor) and 4 (delta) to the PFS under ``tmp / "train"``. A serving
    manager on another geometry cold-starts a two-replica ``ServeFleet``
    from step 2 (every replica byte- and digest-equal to a full restore
    of step 2), both replicas generate the same greedy tokens, the
    follower hot-swaps onto step 4 under a client's generates (none
    dropped or torn; the served digests equal run A's step-4 params'),
    and a serving snapshot saved with the device pre-codec mid-generation
    resumes in a fresh server with the same tokens. Returns the kernel
    launches counted over the phase."""
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import theta_like
    from repro_torch.models import get_model
    from repro_torch.serve import FleetConfig, ServeConfig, ServeFleet

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("qwen1.5-0.5b")
    model = get_model(cfg)
    ref = phase5_reference(cfg, report, **(ref_kw or {}))
    gc.collect()
    reset_counts()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    root = tmp / "train"
    prefix = "['train']['params']"
    scfg = ServeConfig(max_new_tokens=new, s_max=prompt + new)
    row = dict(model=cfg.name, n_layers=cfg.n_layers, batch=batch, prompt=prompt, new=new,
               reference_err=dict(logits=max(ref["logits_err"]), cache=max(ref["cache_err"])))

    # -- cold start: two replicas from step 2, on a 2x1 serving geometry --
    mgr = manager(root, theta_like(2, 1))
    fleet = ServeFleet(model, mgr, model.param_struct(), prefix=prefix,
                       cfg=FleetConfig(n_servers=2, serve=scfg, cache_bytes=SERVE_CACHE_BYTES))
    cs = fleet.cold_start(step=2)
    sync()
    bal = fleet.reader_balance()
    row["cold_start"] = dict(step=cs.step, total_s=cs.total_s, ttft_s=cs.ttft_s,
                             total_bytes=cs.total_bytes, cache=cs.cache,
                             bytes_per_reader=bal["bytes_per_reader"].tolist())
    log(f"phase5 cold start step {cs.step}: total_s={cs.total_s:.3f} ttft_s={cs.ttft_s} "
        f"bytes={cs.total_bytes} cache hits={cs.cache['hits']} "
        f"bytes_saved={cs.cache['bytes_saved']} reader_balance={bal['bytes_per_reader'].tolist()} "
        f"({bal['n_readers']} readers) [{report.get('card')}]")
    if cs.step != 2:
        raise AssertionError(f"phase5: cold start pinned step {cs.step}, not 2")
    full, full_s, _ = restore_step(root, 2, meta_train_target(cfg))
    want = leaves(full["train"]["params"])
    want_digests = device_digests(full["train"]["params"])
    for i, srv in enumerate(fleet.servers):
        got = leaves(srv.params)
        if [n for n, _ in got] != [n for n, _ in want]:
            raise AssertionError(f"phase5: replica {i} has other leaves")
        for (n, x), (_, y) in zip(got, want):
            if x.device.type != DEVICE or x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"phase5: replica {i} leaf {n} differs from the full "
                                     f"restore of step 2 (or is off the card)")
        if not np.array_equal(device_digests(srv.params), want_digests):
            raise AssertionError(f"phase5: replica {i}'s digests differ from step 2's")
    del full, want
    log(f"phase5 both replicas equal the params of a full restore of step 2 byte for byte "
        f"and digest for digest (full restore {full_s:.3f} s)")

    # -- generate: both replicas, the same greedy tokens -----------------
    prompts = {"tokens": np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)}
    toks, gen_s = [], []
    for srv in fleet.servers:
        sync()
        t0 = time.perf_counter()
        out, cache = srv.generate(prompts)
        sync()
        gen_s.append(time.perf_counter() - t0)
        toks.append(out)
        if cache.k.device.type != DEVICE or cache.k.dtype != cfg.cdt:
            raise AssertionError(f"phase5: cache {cache.k.dtype} on {cache.k.device}")
    if not np.array_equal(toks[0], toks[1]):
        raise AssertionError("phase5: the replicas generated different tokens")
    srv = fleet.servers[0]
    with torch.inference_mode():
        dev_prompt = torch.as_tensor(prompts["tokens"], device=DEVICE)
        sync()
        t0 = time.perf_counter()
        pcache, plg = model.prefill(srv.params, {"tokens": dev_prompt}, s_max=prompt + new)
        sync()
        prefill_s = time.perf_counter() - t0
        ptok = plg.argmax(-1)[:, None].to(torch.int32)
        decode_profile = profile_device(lambda: model.decode_step(srv.params, pcache, ptok),
                                        "phase5", "one decode step")
        cast_ms = cuda_ms(lambda: [x.to(cfg.cdt) for _, x in leaves(srv.params)])
        clone_ms = cuda_ms(lambda: (cache.k.clone(), cache.v.clone()))
    del cache, pcache
    gen = gen_s[1]
    decode_ms = 1e3 * (gen - prefill_s) / new
    row["generate"] = dict(generate_s=gen_s, prefill_ms=1e3 * prefill_s,
                           decode_ms_per_token=decode_ms, tokens_per_s=batch * new / gen,
                           param_casts_ms=cast_ms, cache_clone_ms=clone_ms,
                           cast_bytes=sum(x.numel() * 6 for _, x in leaves(srv.params)),
                           decode_profile=decode_profile)
    log(f"phase5 generate batch {batch}x{prompt} +{new} tokens: both replicas equal; "
        f"generate_s={gen_s} prefill_ms={1e3 * prefill_s:.3f} "
        f"decode_ms_per_token={decode_ms:.3f} (generate minus prefill, over {new}) "
        f"tokens_per_s={batch * new / gen:.1f}; per token: param casts {cast_ms} ms "
        f"({row['generate']['cast_bytes']} bytes), cache clone {clone_ms} ms "
        f"[{report.get('card')}]")
    if "busy_share" in decode_profile:
        log(f"phase5 profiled decode step wall {decode_profile['wall_s'] * 1e3:.3f} ms against "
            f"{decode_ms:.3f} ms a token in generate; device busy "
            f"{decode_profile['busy_ms']:.3f} of {decode_profile['device_span_ms']:.3f} ms "
            f"({decode_profile['busy_share']:.4f}) in {decode_profile['n_kernels']} kernels "
            f"[{report.get('card')}]")

    # -- hot swap: the follower adopts step 4 under a client's generates --
    results, errors = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                out, _, v = srv.generate(prompts, with_version=True)
                results.append((v, out))
            except BaseException as e:  # surfaced below
                errors.append(e)
                return

    th = threading.Thread(target=client, name="phase5-client")
    th.start()
    t0 = time.perf_counter()
    fleet.start_follower()
    while fleet.current_step != 4 and time.perf_counter() - t0 < SWAP_DEADLINE_S:
        time.sleep(0.05)
    adopt_s = time.perf_counter() - t0
    while not errors and not any(v == 1 for v, _ in list(results)) \
            and time.perf_counter() - t0 < SWAP_DEADLINE_S:
        time.sleep(0.05)
    stop.set()
    th.join(timeout=SWAP_DEADLINE_S)
    fleet.stop()
    if th.is_alive() or errors:
        raise AssertionError(f"phase5: the client failed or hung: {errors}")
    versions = [v for v, _ in results]
    if fleet.current_step != 4 or 1 not in versions or versions != sorted(versions) \
            or set(versions) - {0, 1}:
        raise AssertionError(f"phase5 hot swap: step {fleet.current_step}, versions {versions}")
    for v, out in results:
        if v == 0 and not np.array_equal(out, toks[0]):
            raise AssertionError("phase5: a version-0 generate during the swap changed tokens")
    v1 = [out for v, out in results if v == 1]
    if any(not np.array_equal(out, v1[0]) for out in v1):
        raise AssertionError("phase5: version-1 generates disagree")
    for i, s in enumerate(fleet.servers):
        if s.params_version != 1 or not np.array_equal(device_digests(s.params), step4_digests):
            raise AssertionError(f"phase5: replica {i} does not serve run A's step-4 params")
    swap_s = fleet.swap_history[-1][1]
    row["hot_swap"] = dict(adopt_s=adopt_s, swap_s=swap_s, generates=len(versions),
                           versions=versions, cache=fleet.cache.stats())
    log(f"phase5 hot swap: follower adopted step 4 after {adopt_s:.3f} s (swap_s={swap_s:.3f}); "
        f"{len(versions)} generates completed, versions {versions}; served digests equal run "
        f"A's step-4 params [{report.get('card')}]")

    # -- snapshot resume: 32 tokens, snapshot, restore, 32 more ----------
    row["snapshot"], _ = serve_snapshot(srv, tmp / "serve_snapshot", report, "phase5",
                                        inputs={"tokens": dev_prompt}, want=v1[0],
                                        s_max=prompt + new)
    fleet.close()
    mgr.close()

    launches = read_counts()
    row["launches"] = launches
    row["peak_device_bytes"] = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase5"] = row
    log(f"phase5 peak_device_bytes={row['peak_device_bytes']} wall {row['wall_s']:.1f} s "
        f"[{report.get('card')}]; launches: {launches}")
    for name in ("fused_precodec", "checksum"):
        if launches[name] == 0:
            raise AssertionError(f"phase5: {name} was not launched on the serving path")
    return launches


# -- phase 6 --------------------------------------------------------------

# free bytes phase 6 needs on the disk of its root: two anchors of the
# train state on L1 and on the PFS (4 x 7.43 GB), a delta, and room
PHASE6_MIN_FREE = 40e9
# the cap, as a share of the rate at which phase 2's anchor flushed
# unthrottled. finetune's anchor must still be flushing when pretrain's
# save asks for a slot, with a margin of 1.5. That rate varies between
# runs (445-659 MB/s on one H100), and pretrain's window beside a flush
# is longer than phase 2's (21 s against 12 s): at a half the margin
# came out 1.31, at a third 1.15 (PERF.md, phase 6). A quarter leaves
# 1.5-2.5.
PHASE6_CAP_SHARE = 1 / 4
PHASE6_JOBS = {"pretrain": 4.0, "finetune": 1.0}    # priority, and weight
PHASE6_CONFIG = dict(strategy="stripe_aligned", codec="zstd+delta", chunk_size=CHUNK_SIZE,
                     device_precodec=True, precodec="none", delta_every=4,
                     health_tick=0.05)


def charge_log(leaf):
    """Record (time, bytes) of every charge a tenant's quota leaf grants:
    the bytes its flush writers let through the arbiter, when they pass."""
    events = []
    acquire = leaf.acquire

    def counted(n, cancel=None):
        waited = acquire(n, cancel)
        events.append((time.perf_counter(), n))
        return waited

    leaf.acquire = counted
    return events


def bytes_between(events, t0, t1):
    return sum(n for t, n in events if t0 <= t <= t1)


def phase6(tmp, pool, report, *, n_layers=PHASE6_LAYERS):
    """Two training jobs checkpoint through one control plane over one
    PFS root, on the card: ``pretrain`` (priority 4) and ``finetune``
    (priority 1) each hold a full train state, share a pending-flush
    budget of 2 and a flush bandwidth cap, and stage with the device
    pre-codec. finetune's anchor flushes under the cap, its step 2 queues
    behind it and fills the budget, pretrain's anchor preempts that
    queued step (parked as ``flush_partial``), both anchors flush through
    the fair-share limiter at 4:1, and finetune's step 2 drains once the
    budget frees. Then pretrain's step 1 and finetune's step 2 restore on
    3x1 with L1 dropped, byte- and digest-equal, and a fresh plane over
    the root recovers both jobs from its registry. Returns the kernel
    launches counted over the phase."""
    import threading

    import numpy as np
    import torch

    from repro_torch.control import ControlPlane
    from repro_torch.core import make_plan, simulate_flush_shared, theta_like

    t_phase = time.perf_counter()
    root = tmp / "plane"
    free_before = shutil.disk_usage(tmp).free
    if free_before < PHASE6_MIN_FREE:
        raise AssertionError(f"phase6: {free_before} bytes free, {PHASE6_MIN_FREE:.0f} needed")
    anchor = report["steps_none"][0]
    rate = anchor["flush_bytes"] / anchor["flush_s"]
    cap = rate * PHASE6_CAP_SHARE
    log(f"phase6 cap={cap:.0f} B/s ({PHASE6_CAP_SHARE:.3f} of phase 2's unthrottled anchor "
        f"flush, {rate:.0f} B/s); free bytes {free_before}")
    gc.collect()
    reset_counts()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    cp = ControlPlane(str(root), device=DEVICE, max_pending_flushes=2, flush_bw_cap=cap)
    mgrs = {name: cp.register_job(name, theta_like(4, 4), priority=prio, **PHASE6_CONFIG)
            for name, prio in PHASE6_JOBS.items()}
    pt, ft = mgrs["pretrain"], mgrs["finetune"]
    charges = {name: charge_log(m._limiter) for name, m in mgrs.items()}
    done = {}                                   # (job, step) -> time of flush_done
    for name in mgrs:
        cp.subscribe(name, lambda s, name=name: done.setdefault((name, s), time.perf_counter()))
    states = {name: make_state(n_layers, DEVICE, pool, seed=SEED + i)
              for i, name in enumerate(PHASE6_JOBS, start=1)}
    pt_state, ft_state = states["pretrain"], states["finetune"]
    copies = {"pretrain": host_copy(pt_state)}
    pre = {"pretrain": device_digests(pt_state)}

    samples, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            samples.append((cp.admission.held(), ft.step_status(2)))
            stop.wait(0.02)

    watcher = threading.Thread(target=watch, name="phase6-watch", daemon=True)
    watcher.start()
    stats = {}
    try:
        ft.stage(1, ft_state)
        stats["finetune", 1] = ft.save(1, ft_state)     # the anchor flushes under the cap
        t_ft_flush = time.perf_counter()
        fine_tune_top_layers(ft_state)
        pre["finetune"] = device_digests(ft_state)
        ft.stage(2, ft_state)
        stats["finetune", 2] = ft.save(2, ft_state)     # queues behind it: budget full
        held_full = cp.admission.held()
        pt.stage(1, pt_state)
        stats["pretrain", 1] = pt.save(1, pt_state)     # asks for a slot
        t_pt_slot = time.perf_counter()
        ft1_in_flight = ("finetune", 1) not in done
        copies["finetune"] = host_copy(ft_state)        # unchanged since its stage
        if not np.array_equal(device_digests(ft_state), pre["finetune"]):
            raise AssertionError("phase6: finetune's state changed after its stage")
        pt.wait()
        ft.wait()
        deadline = time.monotonic() + 600
        while ft.step_status(2) != "flush_done" or stats["finetune", 2].flush is None:
            if time.monotonic() > deadline or ft.flush_errors:
                raise AssertionError(f"phase6: finetune step 2 never drained: "
                                     f"{ft.step_status(2)} {ft.flush_errors}")
            time.sleep(0.05)
    finally:
        stop.set()
        watcher.join()
    samples.append((cp.admission.held(), ft.step_status(2)))
    steps = {name: cp.list_steps(name) for name in mgrs}
    records = {name: cp.record(name) for name in mgrs}
    plans = {name: make_plan("stripe_aligned", theta_like(4, 4),
                             [r.stored_size for r in m._manifest_pfs(1).ranks])
             for name, m in mgrs.items()}
    free_after = shutil.disk_usage(tmp).free

    # -- the arbiter's checks -------------------------------------------
    held_max = max(h for h, _ in samples)
    seen = [st for i, (_, st) in enumerate(samples)
            if st is not None and (i == 0 or samples[i - 1][1] != st)]
    errors = {name: m.flush_errors for name, m in mgrs.items()}
    first = min(t for ev in charges.values() for t, _ in ev)
    last = max(done.values())
    flushed = {name: sum(n for _, n in ev) for name, ev in charges.items()}
    n_ranks = theta_like(4, 4).world_size
    credits = sum(max(1 << 20, cap / 8) + (st.flush.bytes_written / n_ranks)
                  for st in stats.values())
    total = sum(flushed.values())
    floor_s = 0.8 * (total - credits) / cap
    alone_s = stats["finetune", 1].flush.bytes_written / cap
    margin = alone_s / (t_pt_slot - t_ft_flush)
    # both anchors backlogged: from the later first charge to the earlier end
    both = (max(min(t for t, _ in ev) for ev in charges.values()),
            min(done["finetune", 1], done["pretrain", 1]))
    window = {name: bytes_between(ev, *both) for name, ev in charges.items()}
    sims = simulate_flush_shared([plans["pretrain"], plans["finetune"]], flush_bw_cap=cap,
                                 weights=[PHASE6_JOBS["pretrain"], PHASE6_JOBS["finetune"]])
    row = dict(cap=cap, unthrottled_rate=rate, margin=margin, preemptions=cp.admission.preemptions, held_max=held_max,
               held_after_finetune=held_full, finetune_step2_seen=seen,
               finetune_anchor_in_flight=ft1_in_flight, flush_errors=errors,
               flushed_bytes=flushed, elapsed_s=last - first, cap_floor_s=floor_s,
               credit_bytes=credits, both_backlogged_s=both[1] - both[0],
               both_backlogged_bytes=window, free_bytes_before=free_before,
               free_bytes_after=free_after, steps=steps)
    row["saves"] = {f"{name}/{step}": dict(
        stage_s=st.stage_s, window_s=st.encode_time + st.local_time,
        flush_s=st.flush.duration, throttle_wait=st.flush.throttle_wait,
        bytes=st.flush.bytes_written) for (name, step), st in stats.items()}
    row["sim_flush_s"] = {"pretrain": sims[0].flush_time, "finetune": sims[1].flush_time}
    for key, r in row["saves"].items():
        log(f"phase6 {key}: stage_s={r['stage_s']:.4f} window_s={r['window_s']:.4f} "
            f"flush_s={r['flush_s']:.4f} throttle_wait={r['throttle_wait']:.4f} "
            f"bytes={r['bytes']}")
    ratio = window["pretrain"] / max(1, window["finetune"])
    log(f"phase6 both backlogged {both[1] - both[0]:.3f} s: pretrain {window['pretrain']} B, "
        f"finetune {window['finetune']} B, ratio {ratio:.3f} (weights 4:1)")
    log(f"phase6 simulate_flush_shared at the cap, weights 4:1: pretrain "
        f"{sims[0].flush_time:.3f} s, finetune {sims[1].flush_time:.3f} s; measured anchor "
        f"flushes {row['saves']['pretrain/1']['flush_s']:.3f} s and "
        f"{row['saves']['finetune/1']['flush_s']:.3f} s")
    log(f"phase6 margin {margin:.3f} (1.5 wanted): finetune's anchor alone at the cap {alone_s:.3f} s, "
        f"pretrain asked for a slot {t_pt_slot - t_ft_flush:.3f} s after its flush began; "
        f"in flight then: {ft1_in_flight}")
    log(f"phase6 preemptions={row['preemptions']} held_max={held_max} (budget 2, full after "
        f"finetune's step 2: {held_full}); finetune step 2 seen {seen}; flush errors {errors}")
    log(f"phase6 {total} bytes through the cap in {last - first:.3f} s "
        f"(floor 0.8 x (bytes - {credits:.0f} credit) / cap = {floor_s:.3f} s)")
    if row["preemptions"] != 1:
        raise AssertionError(f"phase6: {row['preemptions']} preemptions, not 1 "
                             f"(finetune's anchor in flight when pretrain asked: {ft1_in_flight})")
    if held_max > 2 or held_full != 2:
        raise AssertionError(f"phase6: budget held {held_max} at most, {held_full} when full")
    if seen != ["flush_partial", "flush_done"]:
        raise AssertionError(f"phase6: finetune step 2 went through {seen}")
    if any(errors.values()):
        raise AssertionError(f"phase6: flush errors {errors}")
    if last - first < floor_s:
        raise AssertionError(f"phase6: {total} bytes in {last - first:.3f} s beat the cap")

    # -- restores on 3x1 with L1 dropped, and the registry recovered ------
    cp.close()
    del states, pt_state, ft_state
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    cp2 = ControlPlane(str(root), device=DEVICE, max_pending_flushes=2, flush_bw_cap=cap)
    got_records = {name: cp2.record(name) for name in cp2.jobs()}
    if got_records != records or {n: cp2.list_steps(n) for n in cp2.jobs()} != steps:
        raise AssertionError(f"phase6: the fresh plane recovered {got_records} "
                             f"with steps {[cp2.list_steps(n) for n in cp2.jobs()]}")
    log(f"phase6 a fresh plane recovered {sorted(got_records)} from registry.json with "
        f"steps {steps}")
    for name in mgrs:
        drop_l1(cp2.manager(name))
    row["restore_s"] = {}
    for name, step in (("pretrain", 1), ("finetune", 2)):
        t0 = time.perf_counter()
        got_step, tree = cp2.restore_to_geometry(name, empty_state(n_layers, "meta"),
                                                 theta_like(3, 1), step=step)
        sync()
        row["restore_s"][name] = time.perf_counter() - t0
        assert got_step == step
        same_bytes(leaves(tree), copies.pop(name), f"phase6 {name} step {step}")
        if not np.array_equal(device_digests(tree), pre[name]):
            raise AssertionError(f"phase6: {name} step {step}: restored digests differ")
        del tree
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        log(f"phase6 {name} step {step} restored on 3x1 from the PFS in "
            f"{row['restore_s'][name]:.3f} s: equal to its host copy and its pre-stage digests")
    cp2.close()
    shutil.rmtree(root)

    launches = read_counts()
    row["launches"] = launches
    row["peak_device_bytes"] = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase6"] = row
    log(f"phase6 peak_device_bytes={row['peak_device_bytes']} free bytes before "
        f"{free_before} after {free_after} wall {row['wall_s']:.1f} s [{report.get('card')}]; "
        f"launches: {launches}")
    for name in ("fused_precodec", "checksum"):
        if launches[name] == 0:
            raise AssertionError(f"phase6: {name} was not launched")
    return launches


# -- phase 7 --------------------------------------------------------------

# qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2_7b.py) at its published
# widths, cut to one of its 24 layers: a layer's train state is 6.8 GB and
# the rest (embedding, output) 7.5 GB, and a device pre-codec stage holds
# the state's word stream, its zero base and its delta beside the state
# (about 4x the state: 57 GB at one layer, over 80 GB at two)
MOE_LAYERS = 1
# llava-next-mistral-7b (src/repro/configs/llava_next_mistral_7b.py) cut to
# two of its 32 layers: 698,372,096 bf16 parameters, a 4.19 GB train state
VLM_LAYERS = 2


def host_available_gb():
    """MemAvailable of the host, in GB (None where /proc has no meminfo)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        return None
    return None


def release_host_cache(what):
    """Hand the pinned host blocks that PyTorch's caching host allocator
    keeps after use (each pre-codec stage's D2H buffer: 8 GiB for a
    qwen1.5-0.5b state, 16 GiB for the MoE state) back to the system,
    and log the host's MemAvailable and the pinned bytes held before."""
    import torch

    held = None
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    if DEVICE == "cuda" and stats is not None:
        held = stats().get("allocated_bytes.current")
    empty = getattr(getattr(torch, "accelerator", None), "empty_host_cache", None) or \
        getattr(torch._C, "_host_emptyCache", None)
    if DEVICE == "cuda" and empty is not None:
        empty()
    log(f"host memory {what}: pinned bytes held {held}, released "
        f"{'yes' if DEVICE == 'cuda' and empty is not None else 'no'}; "
        f"MemAvailable {host_available_gb():.1f} GB")


def profile_moe_ffn(cfg, layer_params, batch, seq_len):
    """The MoE FFN of one layer, forward and backward at the trainer's
    shapes (input from a seed, the given layer's weights), under
    :func:`profile_device` and deterministic algorithms: the dispatch and
    combine (the ``index`` class) against the expert products (``matmul``)."""
    import torch

    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models.moe import moe_ffn

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=g, device=DEVICE,
                    dtype=cfg.cdt).requires_grad_()
    p = {k: v.detach().requires_grad_() for k, v in layer_params.items()}

    def fwd_bwd():
        out, aux = moe_ffn(x, p, cfg.moe)
        torch.autograd.grad(out.float().square().mean() + aux, [x, *p.values()])

    with deterministic_algorithms():
        fwd_bwd()        # warm-up
        return profile_device(fwd_bwd, "phase7 moe", "one MoE FFN forward and backward")


def phase7_moe(tmp, report, *, model_cfg=None, seq_len=2048, global_batch=4, ref_kw=None,
               serve_kw=None):
    """qwen2-moe-a2.7b through the port's trainer at its published widths
    (one layer), as phase 4 does for the dense model: run A trains steps
    1-3 with a device pre-codec save of step 2 (an anchor, staged after
    step 2 and saved after step 3); run B, a fresh model, pipeline
    and manager on the same root, restores step 2 from the PFS with L1
    dropped and replays step 3, which must equal run A's byte for byte,
    digest for digest and cursor for cursor. Before, one step against the
    port's CPU (:func:`phase4_reference_step`); after, prefill and 16
    decode steps from run B's params against the CPU
    (:func:`phase5_reference`), and profiles of one clean step and of one
    MoE FFN. Returns the kernel launches counted over runs A and B."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import get_model
    from repro_torch.models.moe import capacity
    from repro_torch.train import OptConfig, TrainConfig, build_train_step

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("qwen2-moe-a2.7b").replace(n_layers=MOE_LAYERS)
    m = cfg.moe
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3), remat=True)
    log(f"phase7 moe model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} experts={m.n_experts} top_k={m.top_k} "
        f"expert_d_ff={m.expert_d_ff} shared={m.n_shared}x{m.shared_d_ff} "
        f"vocab={cfg.vocab_size} params={cfg.param_dtype} compute={cfg.compute_dtype} "
        f"batch={global_batch}x{seq_len} capacity={capacity(m, seq_len)} remat=True")

    ref = phase4_reference_step(cfg, tcfg, report=report, tag="phase7 moe",
                                **dict(dict(seq_len=256, n_layers=cfg.n_layers, global_batch=2),
                                       **(ref_kw or {})))
    marks, auxes, host_gb = [0], [], []  # marks: len(auxes) as each step ends

    def around_a(go):
        host_gb.append(host_available_gb())
        with moe_probe() as (_, recorded):
            auxes.append(recorded)
            a = go()
        host_gb.append(host_available_gb())
        return a

    def log_a(line):
        if line.startswith("step"):
            marks.append(len(auxes[0]))

    # step 2 only, an anchor: run B reads nothing else, and the last step's
    # save (an anchor too: a delta of this state with every chunk dirty took
    # 104.5 s of window against the anchor's 32.3 s) cost 51.8 s of window
    # and 19.8 s of flush (H100 80GB HBM3, 700 W; PERF.md)
    tr = train_and_replay(cfg, tmp / "moe", report, "phase7 moe", seq_len=seq_len,
                          global_batch=global_batch, steps=3, ckpt_every=2, save_last=False,
                          ckpt_kw=dict(delta_every=1), around_a=around_a, log_a=log_a)
    b, auxes = tr.pop("b"), auxes[0]
    losses_a, step_s, saves, peak = tr["losses"], tr["step_s"], tr["saves"], tr["peak"]
    run_a_s, run_b_s, launches = tr["run_a_s"], tr["run_b_s"], tr["launches"]
    aux_a = [sum(auxes[i : i + cfg.n_layers]) for i in marks[:-1]]

    serve = phase5_reference(cfg, report, tag="phase7 moe", params=b.state["params"],
                             **dict(dict(n_layers=cfg.n_layers, batch=2, prompt=2048, steps=16),
                                    **(serve_kw or {})))
    layer0 = {k: v[0] for k, v in b.state["params"]["layers"]["moe"].items()}
    ffn_profile = profile_moe_ffn(cfg, layer0, global_batch, seq_len)
    del layer0
    with deterministic_algorithms():
        # run B's replayed step is its process's first at these shapes: the
        # clean step is the next one, then one more under the profiler
        step = build_train_step(get_model(cfg), tcfg)
        batch = b.data.next()
        sync()
        t0 = time.perf_counter()
        step(b.state, batch)
        sync()
        clean_s = time.perf_counter() - t0
        profile = profile_train_step(cfg, tcfg, b.state, b.data, "phase7 moe")
    replay_s, restore2_s = b.step_s, b.restore_s
    del b
    gc.collect()

    ms = 1e3 * clean_s
    tokens = global_batch * seq_len
    card = report.get("card")
    row = dict(
        model=cfg.name, n_layers=cfg.n_layers, batch=global_batch, seq_len=seq_len,
        losses=losses_a, aux=aux_a, ce=[x - y for x, y in zip(losses_a, aux_a)],
        step_s=step_s, replay_step_s=replay_s, clean_step_ms=ms,
        clean_tokens_per_s=tokens / ms * 1e3,
        peak_device_bytes=peak, host_available_gb=host_gb,
        run_a_s=run_a_s, run_b_s=run_b_s, restore_step2_s=restore2_s,
        saves=[step_row(st, None, None) for st in saves], launches=launches,
        profile=profile, moe_ffn_profile=ffn_profile, reference_step_err=ref["err"],
        reference_routing=ref["routing"], serve_reference_err=max(serve["logits_err"][i]
                                                                  for i in serve["held_steps"]),
        serve_routing=serve["routing"],
    )
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase7_moe"] = row
    log(f"phase7 moe losses {losses_a} (ce {row['ce']}, aux {aux_a}) finite=True")
    log(f"phase7 moe step_ms (run A, synchronised, checkpoint in flight) "
        f"{[round(x * 1e3, 3) for x in step_s]}; run B's replayed step 3 "
        f"{replay_s[0] * 1e3:.3f} ms; clean step_ms (run B's step 4, no checkpoint)="
        f"{ms:.3f} tokens_per_s={row['clean_tokens_per_s']:.1f}; "
        f"peak_device_bytes={peak}; host MemAvailable GB before/after run A "
        f"{row['host_available_gb']} [{card}]")
    log(f"phase7 moe wall {row['wall_s']:.1f} s [{card}]")
    if "busy_share" in profile:
        log(f"phase7 moe profiled step wall {profile['wall_s'] * 1e3:.3f} ms against the clean "
            f"step's {ms:.3f} ms; device busy {profile['busy_ms']:.3f} of "
            f"{profile['device_span_ms']:.3f} ms ({profile['busy_share']:.4f}) [{card}]")
    log(f"phase7 moe launches: fused_precodec={launches['fused_precodec']} "
        f"checksum={launches['checksum']} ({launches})")
    return launches


def phase7_vlm(tmp, report, *, model_cfg=None, seq_len=1472, global_batch=4, ref_kw=None,
               serve_kw=None):
    """llava-next-mistral-7b at its published widths (two layers, bf16
    params and moments): one train step of 576 patch embeddings and text
    against the port's CPU, prefill with patches and 16 decode steps
    against the CPU, then the trainer (``run``) takes one step of batch
    ``global_batch`` x (576 patches + ``seq_len`` text tokens) and saves
    it with the device pre-codec; restored from the PFS on 3x1 with L1
    dropped it must equal its host copy and its pre-stage digests.
    Returns the kernel launches counted over the trainer's run and the
    restore."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointConfig, theta_like
    from repro_torch.launch.train import run
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("llava-next-mistral-7b").replace(n_layers=VLM_LAYERS)
    data_cfg = data_config(cfg, seq_len, global_batch)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=1), remat=True)
    root = tmp / "vlm"
    ckpt = CheckpointConfig(
        root=str(root), cluster=theta_like(4, 4), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=CHUNK_SIZE, device_precodec=True,
        precodec="none", device=DEVICE,
    )
    log(f"phase7 vlm model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"n_patches={cfg.n_patches} params={cfg.param_dtype} compute={cfg.compute_dtype} "
        f"batch={global_batch}x({cfg.n_patches}+{seq_len}) remat=True")
    ref = phase4_reference_step(cfg, tcfg, report=report, tag="phase7 vlm",
                                **dict(dict(seq_len=32, n_layers=cfg.n_layers, global_batch=1),
                                       **(ref_kw or {})))
    serve = phase5_reference(cfg, report, tag="phase7 vlm",
                             **dict(dict(n_layers=cfg.n_layers, batch=2, prompt=64, steps=16),
                                    **(serve_kw or {})))
    gc.collect()
    reset_counts()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = run(cfg, data_cfg, tcfg, ckpt, steps=1, ckpt_every=1, device=DEVICE, seed=SEED,
            log=lambda line: log(f"phase7 vlm {line}"))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    if a.flush_errors or not np.isfinite(a.losses).all():
        raise AssertionError(f"phase7 vlm: flush errors {a.flush_errors}, losses {a.losses}")
    dtypes = {t.dtype for _, t in leaves(a.state["params"])} | \
        {t.dtype for _, t in leaves(a.state["opt"]["mu"])}
    if dtypes != {cfg.pdt}:
        raise AssertionError(f"phase7 vlm: the train state is {dtypes}, not {cfg.pdt}")
    copy = host_copy(a.state)
    digests = device_digests(a.state)     # the state as staged: no step after the stage
    cursor = int(a.data.state_tree()["batch_idx"])
    tree, restore_s, rr = restore_step(root, 1, {"train": a.state, "data": a.data.state_tree()})
    if rr is None or rr.bytes_read == 0:
        raise AssertionError("phase7 vlm: the restore did not read the PFS")
    same_bytes(leaves(tree["train"]), copy, "phase7 vlm restored step 1")
    if not np.array_equal(device_digests(tree["train"]), digests):
        raise AssertionError("phase7 vlm: digests of the restored step 1 differ")
    if int(tree["data"]["batch_idx"]) != cursor:
        raise AssertionError("phase7 vlm: restored step 1 has another batch cursor")
    launches = read_counts()
    st = step_row(a.saves[0], restore_s, rr)
    row = dict(model=cfg.name, n_layers=cfg.n_layers, batch=global_batch,
               n_patches=cfg.n_patches, seq_len=seq_len, losses=a.losses, step_s=a.step_s,
               peak_device_bytes=peak, run_s=run_s, save=st, launches=launches,
               state_bytes=sum(t.numel() * t.element_size() for _, t in copy),
               reference_step_err=ref["err"], serve_reference_err=max(serve["logits_err"]))
    del a, tree, copy
    gc.collect()
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase7_vlm"] = row
    card = report.get("card")
    log(f"phase7 vlm step 1 loss {row['losses']} step_s {row['step_s']} "
        f"peak_device_bytes={peak}; bf16 train state {row['state_bytes']} bytes [{card}]")
    log(f"phase7 vlm save step 1: stage_s={st['stage_s']:.4f} window_s="
        f"{st['blocking_window_s']:.4f} flush_s={st['flush_s']} restore_s={restore_s:.3f} "
        f"(3x1, L1 dropped; equal to its host copy and pre-stage digests); wall "
        f"{row['wall_s']:.1f} s [{card}]")
    log(f"phase7 vlm launches: fused_precodec={launches['fused_precodec']} "
        f"checksum={launches['checksum']} ({launches})")
    return launches


def phase7(tmp, report):
    """qwen2-moe-a2.7b (:func:`phase7_moe`), then llava-next-mistral-7b
    (:func:`phase7_vlm`); returns the kernel launches of both main paths."""
    import torch

    moe = phase7_moe(tmp, report)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    release_host_cache("after phase 7's MoE part")
    vlm = phase7_vlm(tmp, report)
    return {k: moe[k] + vlm[k] for k in moe}




# -- phase 8 --------------------------------------------------------------

# xlstm-350m (src/repro/configs/xlstm_350m.py) at full depth. The
# reference's sLSTM at these widths is chaotic (a one-ulp change of its
# input grows about twice a token and is of order 1 after some 40 tokens),
# and its backward grows as fast with the sequence, on the CPU as on the
# card and in the JAX package as in the port (tests/test_torch_xlstm.py;
# ROADMAP Queue 3): at 4 x 2048 tokens run A's gradients were NaN from
# step 1, and gradient_growth reports the 24 layers' gradient norm at
# XLSTM_GROWTH's lengths (PERF.md). So the sLSTM is held to the CPU in a
# period's step of 8 tokens (the CPU tests hold it to JAX over its first
# 8), the trainer runs 64-token sequences (its 4 x 2048 = 8,192 tokens as
# 128 x 64), and the mLSTM's chunked form is held to the CPU at 2,048 on
# the period's three mLSTMs.
XLSTM_REF_LAYERS = 3
XLSTM_PERIOD_REF = dict(global_batch=8, seq_len=8)
XLSTM_TRAIN = dict(global_batch=128, seq_len=64)
XLSTM_GROWTH = (64, 128, 256)     # lengths of gradient_growth's report
# recurrentgemma-2b (src/repro/configs/recurrentgemma_2b.py) cut to one
# period (rglru, rglru, attn) of its 26 layers: 912,320,000 parameters, a
# 10.9 GB train state. The full state is 34.7 GB, and a pre-codec stage
# holds about four times its state
GRIFFIN_LAYERS = 3


def train_replay_row(cfg, tmp, report, tag, *, seq_len, global_batch, steps):
    """:func:`train_and_replay` of ``cfg`` with one
    save, an anchor of step ``steps - 1`` staged beside the last step, as
    a row of phases 8 and 9; returns it and run B. The last step is not
    saved: a save of griffin's 10.9 GB state cost 22.6-39.1 s of window
    and 13.4 s of flush (H100 80GB HBM3, 700.00 W; PERF.md), and run B
    replays it."""
    tr = train_and_replay(cfg, tmp / tag.split()[-1], report, tag, seq_len=seq_len,
                          global_batch=global_batch, steps=steps, ckpt_every=steps - 1,
                          save_last=False, ckpt_kw=dict(delta_every=1))
    b = tr.pop("b")
    clean_ms = 1e3 * b.step_s[0]
    row = dict(model=cfg.name, n_layers=cfg.n_layers, batch=global_batch, seq_len=seq_len,
               losses=tr["losses"], step_s=tr["step_s"], replay_step_ms=clean_ms,
               replay_tokens_per_s=global_batch * seq_len / clean_ms * 1e3,
               peak_device_bytes=tr["peak"], run_a_s=tr["run_a_s"], run_b_s=tr["run_b_s"],
               restore_s=b.restore_s, restore_bytes_read=b.restore_read.bytes_read,
               state_bytes=sum(t.numel() * t.element_size() for _, t in leaves(b.state)),
               saves=[step_row(st, None, None) for st in tr["saves"]],
               launches=tr["launches"])
    log(f"{tag} step_ms (run A, synchronised, checkpoint beside) "
        f"{[round(x * 1e3, 3) for x in tr['step_s']]}; replayed step {steps} (run B, no "
        f"checkpoint) {clean_ms:.3f} ms, tokens_per_s={row['replay_tokens_per_s']:.1f}; "
        f"peak_device_bytes={tr['peak']}; state {row['state_bytes']} bytes "
        f"[{report.get('card')}]")
    return row, b


def teacher_forcing(cfg, params, report, tag, *, batch, prompt, steps, tol=SERVE_REF_TOL):
    """Prefill of ``batch`` x ``prompt`` tokens (from a seed) and
    ``steps`` greedy decode steps on the card, against one forward pass
    over the prompt and the emitted tokens: each step's logits within
    ``tol["logits"]`` of the forward's largest at its position (the two
    round in other orders)."""
    import numpy as np
    import torch

    from repro_torch.models import get_model

    model = get_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32), device=DEVICE)
    with torch.inference_mode():
        cache, lg = model.prefill(params, {"tokens": toks})
        dec, out = [lg.float()], []
        for _ in range(steps):
            out.append(lg.argmax(-1)[:, None].to(torch.int32))
            lg, cache = model.decode_step(params, cache, out[-1])
            dec.append(lg.float())
        del cache
        full, _ = model.forward(params, {"tokens": torch.cat([toks, *out], dim=1)})
        err = [float((d - f.float()).abs().max() / f.float().abs().max())
               for d, f in zip(dec, full[:, prompt - 1:].unbind(1))]
    del full
    report[f"{tag}_teacher_forcing".replace(" ", "_")] = dict(
        n_layers=cfg.n_layers, batch=batch, prompt=prompt, steps=steps, logits_err=err)
    log(f"{tag} decode against teacher forcing on the card ({cfg.n_layers} layers, batch "
        f"{batch}x{prompt}, {steps} steps): worst logits err {max(err):.3e} of max|logit| "
        f"(tol {tol['logits']:g})")
    if not max(err) <= tol["logits"]:
        raise AssertionError(f"{tag}: decode differs from teacher forcing: {err}")
    return err


def generate_and_snapshot(cfg, params, tmp, report, tag, *, batch, prompt, new):
    """``Server.generate`` of ``batch`` x ``prompt`` tokens (from a seed;
    an audio model's frames from the same seed) and ``new`` greedy
    tokens, then :func:`serve_snapshot` after half of them (its prefill
    and decode steps timed). Returns the phase's row and the snapshot's
    kernel launches."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, Server

    model = get_model(cfg)
    r = np.random.default_rng(SEED)
    inputs = {"tokens": r.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)}
    if cfg.family == "audio":
        inputs["frames"] = r.standard_normal((batch, cfg.enc_seq, cfg.d_model),
                                             dtype=np.float32)
    srv = Server(model, params, ServeConfig(max_new_tokens=new))
    sync()
    t0 = time.perf_counter()
    want, _ = srv.generate(inputs)
    generate_s = time.perf_counter() - t0
    snap, launches = serve_snapshot(
        srv, tmp / f"{tag.split()[-1]}_snapshot", report, tag,
        inputs={k: torch.as_tensor(v, device=DEVICE) for k, v in inputs.items()},
        want=want, s_max=prompt + new)
    decode_ms = snap.pop("decode_ms_per_token")
    row = dict(batch=batch, prompt=prompt, new=new, generate_s=generate_s,
               prefill_ms=snap.pop("prefill_ms"), decode_ms_per_token=decode_ms,
               decode_tokens_per_s=batch / decode_ms * 1e3, snapshot=snap)
    log(f"{tag} generate batch {batch}x{prompt} +{new} tokens: {generate_s:.3f} s; prefill "
        f"{row['prefill_ms']:.3f} ms, decode {decode_ms:.3f} ms a token "
        f"({row['decode_tokens_per_s']:.1f} tokens/s) [{report.get('card')}]")
    return row, launches


def timed_step(cfg, global_batch, seq_len, *, profile_tag=None):
    """One synchronised train step of ``cfg`` (a fresh state from the
    seed) after one warm-up step, in seconds; with ``profile_tag`` a
    further step under :func:`profile_device`. Under deterministic
    algorithms, as the trainer runs."""
    import torch

    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import deterministic_algorithms
    from repro_torch.models import get_model
    from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state

    model = get_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3), remat=True)
    state = init_train_state(model, torch.Generator(device=DEVICE).manual_seed(SEED), tcfg,
                             DEVICE)
    data = SyntheticTokens(data_config(cfg, seq_len, global_batch), device=DEVICE)
    step = build_train_step(model, tcfg)
    with deterministic_algorithms():
        step(state, data.next())
        batch = data.next()
        sync()
        t0 = time.perf_counter()
        step(state, batch)
        sync()
        secs = time.perf_counter() - t0
        batch = data.next()
        prof = None if profile_tag is None else profile_device(
            lambda: step(state, batch), profile_tag, f"one step of {cfg.n_layers} layers")
    return secs, prof


def gradient_growth(cfg, params, report, tag, *, lengths, batch=8):
    """The norm of ``cfg``'s loss gradient at ``params`` over ``batch``
    sequences (from a seed) of each of ``lengths``: how the sLSTM's
    backward grows with the sequence. Measured, not held."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.utils.treelib import flatten_with_names, unflatten

    model = get_model(cfg)
    named, treedef = flatten_with_names(params)
    xs = [x.detach().clone().requires_grad_() for _, x in named]
    norms = {}
    for s in lengths:
        toks = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
            0, cfg.vocab_size, (batch, s)).astype(np.int32), device=DEVICE)
        loss, _ = model.loss(unflatten(treedef, xs), {"tokens": toks})
        grads = torch.autograd.grad(loss, xs)
        norms[s] = float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])))
        del loss, grads
    del xs
    gc.collect()
    report[f"{tag}_gradient_norm_by_length".replace(" ", "_")] = norms
    log(f"{tag} loss gradient norm of {cfg.n_layers} layers over {batch} sequences, by "
        f"length: {norms} [{report.get('card')}]")
    return norms


def phase8_xlstm(tmp, report, *, model_cfg=None, train_kw=None, ref_kw=None,
                 period_ref_kw=None, serve_kw=None):
    """xlstm-350m at its published widths and full depth: float32 steps
    against the CPU of one period (the sLSTM in it, ``XLSTM_PERIOD_REF``)
    and of its three mLSTM layers at 1 x 2048 (the carried state crosses
    a chunk boundary); the trainer's run A and run B
    (:func:`train_replay_row`, steps 1-3 at ``XLSTM_TRAIN``, every loss
    finite) and the gradient norm by length; serving from run B's params
    (generate 8 x 2048 + 16, a snapshot after 8 tokens); the sLSTM's
    share of a step (a step of one period against one of its three
    mLSTMs) and a device profile of one period; prefill and 16 decode
    steps of the three mLSTM layers against the CPU and against teacher
    forcing on the card. Returns the kernel launches of the main path
    (the runs and the snapshot)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("xlstm-350m")
    tag = "phase8 xlstm"
    train_kw = dict(XLSTM_TRAIN, **(train_kw or {}))
    log(f"{tag} model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads} kinds={''.join(k[0] for k in cfg.layer_kinds())} "
        f"vocab={cfg.vocab_size} params={cfg.param_dtype} compute={cfg.compute_dtype} "
        f"batch={train_kw['global_batch']}x{train_kw['seq_len']} remat=True")
    period = len(cfg.pattern)
    n_ref = min(XLSTM_REF_LAYERS, cfg.n_layers)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3), remat=True)
    # float32 compute: the mLSTM's output is nearly invariant to a common
    # shift of its input gates' pre-activations (the stabiliser m absorbs
    # it), so the gradients of b_i (and, less, of b_f, w_f, w_i and the
    # conv) are residues of a cancellation, and bf16 rounding moved their
    # mu by 0.03-2.06 of their norm between card and CPU (PERF.md)
    f32 = cfg.replace(compute_dtype="float32")
    ref_period = phase4_reference_step(f32, tcfg, report=report, tag=f"{tag} period", **dict(
        dict(XLSTM_PERIOD_REF, n_layers=period), **(period_ref_kw or {})))
    ref = phase4_reference_step(f32, tcfg, report=report, tag=tag, **dict(
        dict(seq_len=2048, n_layers=n_ref, global_batch=1), **(ref_kw or {})))
    row, b = train_replay_row(cfg, tmp, report, tag, steps=3, **train_kw)
    params = b.state["params"]
    del b
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    growth = gradient_growth(cfg, params, report, tag, lengths=XLSTM_GROWTH)
    gc.collect()
    release_host_cache(f"after {tag}'s training")
    # serving comes before the timed and profiled steps: after them the
    # first generate, its prefill eager, took 25.1 s on an H100 (PERF.md)
    serve, served = generate_and_snapshot(cfg, params, tmp, report, tag, **dict(
        dict(batch=8, prompt=2048, new=16), **(serve_kw or {})))
    del params
    gc.collect()
    t_period, prof = timed_step(cfg.replace(n_layers=period), profile_tag=tag, **train_kw)
    t_mlstm, _ = timed_step(cfg.replace(n_layers=period - 1), **train_kw)
    n_slstm = cfg.layer_kinds().count("slstm")
    slstm_s = t_period - t_mlstm
    share = n_slstm * slstm_s / (row["replay_step_ms"] / 1e3)
    row.update(period_step_s=t_period, mlstm_only_step_s=t_mlstm, slstm_layer_s=slstm_s,
               slstm_share=share, profile=prof, reference_step_err=ref["err"],
               period_reference_step_err=ref_period["err"], gradient_norm_by_length=growth)
    card = report.get("card")
    log(f"{tag} one period's step {t_period:.3f} s, its three mLSTMs' {t_mlstm:.3f} s: an "
        f"sLSTM layer {slstm_s:.3f} s of a step, {n_slstm} of them {share:.4f} of the "
        f"replayed step [{card}]")
    if prof and "busy_share" in prof:
        log(f"{tag} profiled period step: device busy {prof['busy_ms']:.3f} of "
            f"{prof['device_span_ms']:.3f} ms ({prof['busy_share']:.4f}) [{card}]")

    # the mLSTM's decode state against the CPU and teacher forcing, in
    # float32 compute (SERVE_REF_TOL_F32), as the reference's own decode test
    ref_cfg = cfg.replace(n_layers=n_ref, compute_dtype="float32")
    skw = dict(dict(batch=2, prompt=2048, steps=16), **(serve_kw or {}))
    skw.pop("new", None)
    serve_ref = phase5_reference(ref_cfg, report, n_layers=n_ref, tag=tag,
                                 tol=SERVE_REF_TOL_F32, **skw)
    cut = get_model(ref_cfg).init(torch.Generator(device=DEVICE).manual_seed(SEED),
                                  DEVICE).state_tree()
    tf = teacher_forcing(ref_cfg, cut, report, tag, tol=SERVE_REF_TOL_F32, **skw)
    del cut
    launches = {k: row["launches"][k] + served[k] for k in served}
    row.update(serve=serve, serve_reference_err=max(serve_ref["logits_err"]),
               teacher_forcing_err=max(tf), launches=launches)
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase8_xlstm"] = row
    log(f"{tag} wall {row['wall_s']:.1f} s; launches: fused_precodec="
        f"{launches['fused_precodec']} checksum={launches['checksum']} ({launches})")
    return launches


def phase8_griffin(tmp, report, *, model_cfg=None, seq_len=4096, global_batch=1, ref_kw=None,
                   serve_kw=None):
    """recurrentgemma-2b at its published widths, cut to one period of 3
    layers: one step against the CPU (1 x 512 tokens); the trainer's run
    A and run B (:func:`train_replay_row`, steps 1-2 at batch 1 x 4096, past
    the 2,048-token window); serving from run B's params (generate 4 x
    4096 + 16, so the ring buffers wrap; a snapshot of params, ring
    caches and RG-LRU state after 8 tokens) and decode against teacher
    forcing on the card. Returns the kernel launches of the main path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("recurrentgemma-2b").replace(n_layers=GRIFFIN_LAYERS)
    tag = "phase8 griffin"
    log(f"{tag} model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.hd} d_ff={cfg.d_ff} "
        f"window={cfg.window} vocab={cfg.vocab_size} (tied) params={cfg.param_dtype} "
        f"compute={cfg.compute_dtype} batch={global_batch}x{seq_len} remat=True")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=2), remat=True)
    ref = phase4_reference_step(cfg, tcfg, report=report, tag=tag, **dict(
        dict(seq_len=512, n_layers=cfg.n_layers, global_batch=1), **(ref_kw or {})))
    row, b = train_replay_row(cfg, tmp, report, tag, seq_len=seq_len,
                              global_batch=global_batch, steps=2)
    params = b.state["params"]
    del b
    gc.collect()
    release_host_cache(f"after {tag}'s training")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    skw = dict(dict(batch=4, prompt=seq_len, new=16), **(serve_kw or {}))
    serve, served = generate_and_snapshot(cfg, params, tmp, report, tag, **skw)
    tf = teacher_forcing(cfg, params, report, tag, batch=skw["batch"], prompt=skw["prompt"],
                         steps=skw["new"])
    serve_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    del params
    gc.collect()
    launches = {k: row["launches"][k] + served[k] for k in served}
    row.update(serve=serve, serve_peak_device_bytes=serve_peak, teacher_forcing_err=max(tf),
               reference_step_err=ref["err"], launches=launches)
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase8_griffin"] = row
    log(f"{tag} serving peak_device_bytes={serve_peak}; wall {row['wall_s']:.1f} s "
        f"[{report.get('card')}]; launches: fused_precodec={launches['fused_precodec']} "
        f"checksum={launches['checksum']} ({launches})")
    return launches


def phase8(tmp, report):
    """xlstm-350m (:func:`phase8_xlstm`), then recurrentgemma-2b
    (:func:`phase8_griffin`); returns the kernel launches of both main
    paths."""
    import torch

    from repro_torch.models.xlstm import release_graphs

    xl = phase8_xlstm(tmp, report)
    release_graphs()
    for old in tmp.iterdir():
        shutil.rmtree(old) if old.is_dir() else old.unlink()
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    release_host_cache("after phase 8a")
    gr = phase8_griffin(tmp, report)
    gc.collect()
    release_host_cache("after phase 8b")
    return {k: xl[k] + gr[k] for k in xl}


# -- phase 9 --------------------------------------------------------------

# whisper-small (src/repro/configs/whisper_small.py) at full width and full
# depth: 239,435,520 parameters, a 2,873,226,240-byte float32 train state.
# The trainer's batch: 16 rows of 1,500 frames (30 s of audio at 50 Hz)
# and 448 decoder tokens (whisper's text context); serving: 8 rows of a
# 32-token prompt and 64 new tokens.
WHISPER_TRAIN = dict(global_batch=16, seq_len=448)
WHISPER_SERVE = dict(batch=8, prompt=32, new=64)


def phase9(tmp, report, *, model_cfg=None, train_kw=None, ref_kw=None, serve_ref_kw=None,
           serve_kw=None):
    """whisper-small at its published widths and full depth: one float32
    step at 2 + 2 layers (batch 1 x (1,500 frames, 64 tokens)) and bf16
    prefill and 16 decode steps at 2 + 2 layers, each against the port's
    CPU; the trainer's run A and run B (:func:`train_replay_row`, steps
    1-3 at ``WHISPER_TRAIN``, step 2 an anchor staged beside step 3, run
    B replaying step 3 byte for byte); serving from run B's params
    (generate ``WHISPER_SERVE`` and a snapshot of params, the
    ``WhisperCache`` with its cross K/V and the next token after half of
    the new tokens, restored from the PFS into a fresh server). Returns
    the kernel launches of the main path (the runs and the snapshot)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.models import get_model
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("whisper-small")
    tag = "phase9 whisper"
    train_kw = dict(WHISPER_TRAIN, **(train_kw or {}))
    b_, s_ = train_kw["global_batch"], train_kw["seq_len"]
    card = report.get("card")
    log(f"{tag} model: {cfg.name} layers={cfg.n_enc_layers}+{cfg.n_layers} "
        f"d_model={cfg.d_model} heads={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"(tied) enc_seq={cfg.enc_seq} params={cfg.param_dtype} compute={cfg.compute_dtype} "
        f"batch={b_}x({cfg.enc_seq} frames+{s_} tokens) remat=True")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3), remat=True)
    ref = phase4_reference_step(cfg.replace(compute_dtype="float32"), tcfg, report=report,
                                tag=tag, **dict(dict(seq_len=64, n_layers=2, global_batch=1),
                                                **(ref_kw or {})))
    serve_ref = phase5_reference(cfg, report, tag=tag, **dict(
        dict(n_layers=2, batch=2, prompt=64, steps=16), **(serve_ref_kw or {})))
    row, b = train_replay_row(cfg, tmp, report, tag, steps=3, **train_kw)
    params = b.state["params"]
    del b
    gc.collect()
    release_host_cache(f"after {tag}'s training")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    serve, served = generate_and_snapshot(cfg, params, tmp, report, tag,
                                          **dict(WHISPER_SERVE, **(serve_kw or {})))
    serve_peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    del params
    gc.collect()

    step_s = row["replay_step_ms"] / 1e3
    n_params = get_model(cfg).param_count()
    flops = model_flops("train", n_params, b_, s_)
    launches = {k: row["launches"][k] + served[k] for k in served}
    row.update(
        enc_layers=cfg.n_enc_layers, enc_seq=cfg.enc_seq, param_count=n_params,
        replay_frames_per_s=b_ * cfg.enc_seq / step_s,
        model_flops_decoder_tokens=flops, model_flops_share_of_peak=flops / step_s / PEAK_FLOPS,
        serve=serve, serve_peak_device_bytes=serve_peak, reference_step_err=ref["err"],
        serve_reference_err=max(serve_ref["logits_err"]), launches=launches)
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase9_whisper"] = row
    st = row["saves"][0]
    log(f"{tag} losses {row['losses']}; replayed step 3 {row['replay_step_ms']:.3f} ms: "
        f"{row['replay_tokens_per_s']:.1f} decoder tokens/s, "
        f"{row['replay_frames_per_s']:.1f} frames/s; peak_device_bytes="
        f"{row['peak_device_bytes']} [{card}]")
    log(f"{tag} save step 2: stage_s={st['stage_s']:.4f} window_s="
        f"{st['blocking_window_s']:.4f} flush_s={st['flush_s']}; restore_s={row['restore_s']:.3f} "
        f"({row['restore_bytes_read']} bytes from the PFS, L1 dropped) [{card}]")
    log(f"{tag} model_flops('train', {n_params}, {b_}, {s_}) = {flops:.4e}: 6*N*D over the "
        f"decoder's tokens only (not the encoder's {cfg.enc_seq} frames a row), over the "
        f"replayed step and PEAK_FLOPS = {row['model_flops_share_of_peak']:.4f} [{card}]")
    log(f"{tag} serving peak_device_bytes={serve_peak}; wall {row['wall_s']:.1f} s [{card}]; "
        f"launches: fused_precodec={launches['fused_precodec']} "
        f"checksum={launches['checksum']} ({launches})")
    return launches


# -- phase 10 -------------------------------------------------------------


def phase10(tmp, report, *, model_cfg=None, seq_len=2048, global_batch=4):
    """The mesh layer on the card: phase 4's model (``model_cfg``; ``main``
    passes qwen1.5-0.5b at ``PHASE4_LAYERS``), batch, seed, ``TrainConfig``
    and checkpoint config through ``run(..., mesh=make_host_mesh())``, a
    1x1 ``("data", "model")`` mesh on a process group of world size 1
    (nccl on the card): the state placed by ``train_state_specs``, each
    step ``make_train_step``'s. Run A takes steps 1-3 saving step 2 beside
    step 3; run B restores step 2 from the PFS with L1 dropped into its
    mesh-placed state and replays step 3 byte for byte
    (:func:`train_and_replay`; every leaf of both a DTensor placed by the
    specs). Step 2's chunk digests and leaf table must equal phase 4's
    step 2. The group is destroyed at the end. Returns the launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("qwen1.5-0.5b")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4), remat=True)   # phase 4's
    root = tmp / "mesh"
    card = report.get("card")
    mesh = make_host_mesh(DEVICE)
    try:
        log(f"phase10 model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
            f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
            f"batch={global_batch}x{seq_len} on {mesh} ({dist.get_backend()} group of "
            f"world size {dist.get_world_size()})")
        tr = train_and_replay(cfg, root, report, "phase10", seq_len=seq_len,
                              global_batch=global_batch, steps=3, ckpt_every=2,
                              save_last=False, tcfg=tcfg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    b = tr.pop("b")
    step2 = ckpt_chunk_digests(root, 2)
    want = report["phase4"]["step2_chunk_digests"]
    if step2 != want:
        raise AssertionError(f"phase10: step 2's chunk digests {step2} != phase 4's {want}")
    st = tr["saves"][0]
    fl = st.flush
    clean_ms = 1e3 * b.step_s[0]
    row = dict(model=cfg.name, n_layers=cfg.n_layers, batch=global_batch, seq_len=seq_len,
               mesh=str(mesh), losses=tr["losses"], step_s=tr["step_s"],
               replay_step_ms=clean_ms,
               replay_tokens_per_s=global_batch * seq_len / clean_ms * 1e3,
               peak_device_bytes=tr["peak"], run_a_s=tr["run_a_s"], run_b_s=tr["run_b_s"],
               restore_s=b.restore_s, restore_bytes_read=b.restore_read.bytes_read,
               saves=[step_row(st, None, None) for st in tr["saves"]],
               step2_chunk_digests=step2, launches=tr["launches"])
    del b, tr
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase10"] = row
    log(f"phase10 step_ms (run A, synchronised, checkpoint beside) "
        f"{[round(x * 1e3, 3) for x in row['step_s']]}; replayed step 3 (run B, no "
        f"checkpoint) {clean_ms:.3f} ms, tokens_per_s={row['replay_tokens_per_s']:.1f}; "
        f"peak_device_bytes={row['peak_device_bytes']} [{card}]")
    log(f"phase10 save step 2: stage_s={st.stage_s:.4f} window_s="
        f"{st.encode_time + st.local_time:.4f} flush_s={fl.duration if fl else None}; "
        f"restore_s={row['restore_s']:.3f} ({row['restore_bytes_read']} bytes from the PFS, "
        f"L1 dropped) [{card}]")
    log(f"phase10 step 2's {step2['chunks']} chunk digests equal phase 4's step 2; "
        f"wall {row['wall_s']:.1f} s [{card}]; launches: {row['launches']}")
    return row["launches"]


# (name, report key, source, the TPU kernel's body it replaces)
KERNEL_ROWS = [
    ("fused_precodec", "fused", "src/repro_torch/kernels/fused/csrc/fused_precodec.cu",
     "src/repro/kernels/fused/fused.py:36"),
    ("quantize", "quantize", "src/repro_torch/kernels/quantize/csrc/quantize.cu",
     "src/repro/kernels/quantize/quantize.py:20"),
    ("dequantize", "dequantize", "src/repro_torch/kernels/quantize/csrc/dequantize.cu",
     "src/repro/kernels/quantize/quantize.py:32"),
    ("checksum", "checksum", "src/repro_torch/kernels/checksum/csrc/checksum.cu",
     "src/repro/kernels/checksum/checksum.py:24"),
    ("xor_delta", "xor_delta", "src/repro_torch/kernels/delta/csrc/delta.cu",
     "src/repro/kernels/delta/delta.py:20"),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=PHASE2_LAYERS,
                    help=f"depth of phase 2's model state, {PHASE2_LAYERS} of qwen1.5-0.5b's "
                         f"{N_LAYERS} by default (widths are never cut; phases 1 and 3 run "
                         f"all {N_LAYERS}, phases 4 and 5 {PHASE4_LAYERS}, phase 6 "
                         f"{PHASE6_LAYERS}, phase 7 {MOE_LAYERS} of qwen2-moe-a2.7b's 24 and "
                         f"{VLM_LAYERS} of llava-next-mistral-7b's 32, phase 8 all 24 of "
                         f"xlstm-350m's and {GRIFFIN_LAYERS} of recurrentgemma-2b's 26, "
                         f"phase 9 all 12 + 12 of whisper-small's, phase 10 "
                         f"{PHASE4_LAYERS} of qwen1.5-0.5b's)")
    args = ap.parse_args(argv)

    # cuBLAS reads this when it makes its handle; phase 4's bit-exact
    # replay needs its fixed workspace (deterministic reductions)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "build.py").is_file():
        print(f"chip_smoke: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    libs = build.build_all()
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": time.perf_counter() - t0, "libraries": libs}
    log(f"phase0 built {sorted(libs)} in {report['build_s']:.2f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase0 ptxas {name}: {line.strip()}")

    n_words, n_quant = state_words(N_LAYERS), quantized_values(N_LAYERS)
    phase_s = report["phase_s"] = {}
    t0 = time.perf_counter()
    phase1_fused(n_words, report)
    phase1_quantize(n_quant, report)
    phase1_checksum(n_words, report)
    phase1_delta(n_words, report)
    phase1_dequantize(n_quant, report)
    phase_s["1"] = time.perf_counter() - t0

    out_dir = ROOT / "chiprun_out"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        launches2 = phase2(args.layers, Path(tmp), pool, report)
        phase_s["2"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache("after phase 2")
        t0 = time.perf_counter()
        launches3 = phase3(pool, report)
        phase_s["3"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        from repro_torch.configs import get_config

        qwen = get_config("qwen1.5-0.5b").replace(n_layers=PHASE4_LAYERS)
        launches4, step4_digests = phase4(Path(tmp), report, model_cfg=qwen)
        phase_s["4"] = time.perf_counter() - t0
        gc.collect()
        release_host_cache("after phase 4")
        t0 = time.perf_counter()
        launches5 = phase5(Path(tmp), report, step4_digests, model_cfg=qwen)
        phase_s["5"] = time.perf_counter() - t0
        # room for phase 6: clear everything under tmp (phase 2 removed its
        # roots; phases 4 and 5 leave theirs)
        for old in Path(tmp).iterdir():
            shutil.rmtree(old) if old.is_dir() else old.unlink()
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache("after phase 5")
        t0 = time.perf_counter()
        launches6 = phase6(Path(tmp), pool, report)
        phase_s["6"] = time.perf_counter() - t0
        # room for phase 7: phase 6's roots go too
        for old in Path(tmp).iterdir():
            shutil.rmtree(old) if old.is_dir() else old.unlink()
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache("after phase 6")
        t0 = time.perf_counter()
        launches7 = phase7(Path(tmp), report)
        phase_s["7"] = time.perf_counter() - t0
        # room for phase 8: phase 7's roots go too
        for old in Path(tmp).iterdir():
            shutil.rmtree(old) if old.is_dir() else old.unlink()
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache("after phase 7")
        t0 = time.perf_counter()
        launches8 = phase8(Path(tmp), report)
        phase_s["8"] = time.perf_counter() - t0
        # room for phase 9: phase 8's roots go too
        for old in Path(tmp).iterdir():
            shutil.rmtree(old) if old.is_dir() else old.unlink()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches9 = phase9(Path(tmp), report)
        phase_s["9"] = time.perf_counter() - t0
        # room for phase 10: phase 9's roots go too
        for old in Path(tmp).iterdir():
            shutil.rmtree(old) if old.is_dir() else old.unlink()
        gc.collect()
        torch.cuda.empty_cache()
        release_host_cache("after phase 9")
        t0 = time.perf_counter()
        launches10 = phase10(Path(tmp), report, model_cfg=qwen)
        phase_s["10"] = time.perf_counter() - t0
        release_host_cache("after phase 10")
    launches = [launches2, launches3, launches4, launches5, launches6, launches7, launches8,
                launches9, launches10]
    report["launches"] = {f"phase{i}": n for i, n in enumerate(launches, start=2)}

    kernels = []
    for name, key, source, replaces in KERNEL_ROWS:
        r = report[key]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(n[name] for n in launches),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
        ))
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total_s={report['total_s']:.1f} build_s={report['build_s']:.1f} "
        + " ".join(f"phase{k}_s={v:.1f}" for k, v in phase_s.items()))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
