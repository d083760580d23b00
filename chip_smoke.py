#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (an H100), end to end.

    python3 chip_smoke.py [--layers N]

Phase 0 prints the card and builds the five CUDA kernels from the
sources in this checkout (``src/repro_torch/kernels/*/csrc/*.cu``, with
``nvcc``, all started together, into ``build/repro_torch/``).

Phase 1 holds each kernel against its plain PyTorch version on the card,
at the shapes the main path gives it and on constructed edge cases, and
times both (and, for dequantize, the one PyTorch call that computes the
same function). Equality is exact (tolerance zero).

Phase 2 is the main path: the training state of qwen1.5-0.5b at its
published widths (``src/repro/configs/qwen1_5_0_5b.py``: 24 layers,
d_model 1024, d_ff 2816, vocab 151936, untied output, QKV bias) with
AdamW moments, all float32 from a NumPy seed, lives on the card. Three
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

Phase 3 runs the pre-fusion chain on the main path's words: the state's
word stream (the pre-codec's own assembly) before and after a fine-tune
of the top layers, ``xor_delta`` of the two, one ``checksum_u32`` per
1 MiB chunk and the per-chunk dirty counts as one reduction, held equal
to ``fused_precodec`` of the same streams; both wall times are logged.
``--layers`` cuts the depth (never a width) when a run must be shorter.

Phase 4 is the port's trainer (``repro_torch.launch.train.run``) at
qwen1.5-0.5b's full width and depth (float32 params, bfloat16 compute,
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
``ServeFleet`` from step 2 at full depth (every replica byte- and
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

Prints the card's name and power limit, per-step numbers, one JSON line
of kernels, and last ``{"ok": true, "device": {...}}``. Exits non-zero
(with no result) without a CUDA device, outside the repository, or when
any check fails. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEED = 20211203

# qwen1.5-0.5b (src/repro/configs/qwen1_5_0_5b.py)
VOCAB, D_MODEL, D_FF, N_LAYERS = 151936, 1024, 2816, 24
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
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
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


def make_state(n_layers, device, pool):
    """The train state on ``device``, values from a NumPy seed: params and
    mu standard normal, nu positive (|N(0,1)| * 1e-3 + 1e-8)."""
    import numpy as np
    import torch

    block = 1 << 24

    def tree():
        t = {"embed": None, "final_norm": None, "out": None, "layers": {}}
        for path, shape in state_specs(n_layers):
            leaf = torch.empty(shape, dtype=torch.float32, device=device)
            if len(path) == 1:
                t[path[0]] = leaf
            else:
                t["layers"][path[1]] = leaf
        return t

    state = {"params": tree(), "opt": {"mu": tree(), "nu": tree(),
                                       "count": torch.zeros((), dtype=torch.int32, device=device)},
             "step": torch.zeros((), dtype=torch.int32, device=device)}
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
        a = np.random.default_rng([SEED, *key]).standard_normal(hi - lo, dtype=np.float32)
        if group == "nu":
            a = np.abs(a) * np.float32(1e-3) + np.float32(1e-8)
        return job, a

    for (group, flat, lo, hi, _), a in pool.map(gen, jobs):
        flat[lo:hi].copy_(torch.from_numpy(a))
    sync()
    return state


def leaves(tree):
    from repro_torch.utils.treelib import flatten_with_names

    return flatten_with_names(tree)[0]


def fine_tune_top_layers(state):
    """In place: a fine-tune of the top four layers (params, mu, nu)."""
    for t in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for leaf in t["layers"].values():
            leaf[-4:].mul_(0.999).add_(1e-4)     # layers 20:24 of 24
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


def assert_equal_to_host(tree, copy, what):
    import torch

    got = leaves(tree)
    assert [n for n, _ in got] == [n for n, _ in copy], what
    for (n, t), (_, h) in zip(got, copy):
        assert t.dtype == h.dtype and t.shape == h.shape, (what, n)
        if not torch.equal(t, h.to(t.device)):
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
    """The main path. Returns the state (phase 3 goes on from it) and
    the kernel launches counted over this phase."""
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
        assert_equal_to_host(tree, copies[step], f"step {step}")
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
    return state, launches


# -- phase 3 --------------------------------------------------------------


def phase3(state, report):
    """The pre-fusion chain (benchmarks/kernel_bench.py's per-kernel
    pass) on the main path's words, held equal to the fused pass."""
    import torch

    from repro_torch.core.precodec import DevicePrecodec
    from repro_torch.kernels.checksum.ops import checksum_u32
    from repro_torch.kernels.delta.ops import xor_delta
    from repro_torch.kernels.fused.ops import fused_precodec

    cw = CHUNK_SIZE // 4
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
        # what phase 2's objects still hold on the card, before and after
        # a collection of reference cycles
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
    del prev, cur
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


def profile_train_step(cfg, tcfg, state, data):
    """One more train step on ``state`` under :func:`profile_device`."""
    from repro_torch.models import get_model
    from repro_torch.train import build_train_step

    step = build_train_step(get_model(cfg), tcfg)
    batch = data.next()
    return profile_device(lambda: step(state, batch), "phase4", "one clean step")


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
# scatter-add) is off by far more
REF_STEP_TOL = {"loss": 1e-3, "grad_norm": 2e-2, "mu": 2e-2, "update_norm": 2e-2}


def phase4_reference_step(cfg, tcfg, seq_len, report, *, n_layers=2, global_batch=2):
    """One train step of ``cfg`` at its full widths and ``seq_len``,
    depth cut to ``n_layers``, from the same state (from a seed) on the
    same batch, on the card and on the CPU through the port's own step:
    loss and grad_norm, and per leaf mu and the update's norm, within
    ``REF_STEP_TOL`` (relative); lr equal."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.utils.convert import train_state_from_numpy, tree_to_numpy
    from repro_torch.utils.treelib import flatten_with_names

    cfg = cfg.replace(n_layers=n_layers)
    model = get_model(cfg)
    start = tree_to_numpy(init_train_state(model, torch.Generator().manual_seed(SEED), tcfg, "cpu"))
    batch = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                       global_batch=global_batch, seed=SEED), device="cpu").next()
    step = build_train_step(model, tcfg)
    out = {}
    for dev in (DEVICE, "cpu"):
        state = train_state_from_numpy(start, model, dev)
        sync()
        t0 = time.perf_counter()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        metrics = {k: float(v) for k, v in m.items()}
        secs = time.perf_counter() - t0
        out[dev] = (tree_to_numpy(state), metrics, secs)
        del state, m
    (g, gm, g_s), (c, cm, c_s) = out[DEVICE], out["cpu"]

    def rel(x, y):
        return float(np.linalg.norm(x.astype(np.float64) - y) / max(np.linalg.norm(y), 1e-30))

    err = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in ("loss", "grad_norm")}
    mu, upd = {}, {}
    for (n, x), (_, y), (_, p0) in zip(flatten_with_names(g["params"])[0],
                                      flatten_with_names(c["params"])[0],
                                      flatten_with_names(start["params"])[0]):
        nx = np.linalg.norm(x.astype(np.float64) - p0)
        ny = np.linalg.norm(y.astype(np.float64) - p0)
        upd[n] = float(abs(nx - ny) / ny)
    for (n, x), (_, y) in zip(flatten_with_names(g["opt"]["mu"])[0],
                              flatten_with_names(c["opt"]["mu"])[0]):
        mu[n] = rel(x, y)
    err["mu"], err["update_norm"] = max(mu.values()), max(upd.values())
    row = dict(n_layers=n_layers, batch=global_batch, seq_len=seq_len, metrics=gm,
               cpu_metrics=cm, step_s=g_s, cpu_step_s=c_s, err=err, tol=REF_STEP_TOL,
               mu_rel=mu, update_norm_rel=upd)
    report["phase4_reference_step"] = row
    log(f"phase4 reference step ({cfg.name} widths, {n_layers} layers, batch "
        f"{global_batch}x{seq_len}): card {gm} in {g_s:.3f} s, cpu {cm} in {c_s:.3f} s")
    log("phase4 reference step relative errors: "
        + " ".join(f"{k}={v:.3e} (tol {REF_STEP_TOL[k]:g})" for k, v in err.items())
        + f"; worst mu leaf {max(mu, key=mu.get)}")
    bad = {k: v for k, v in err.items() if not v <= REF_STEP_TOL[k]}
    if bad or abs(gm["lr"] - cm["lr"]) > 1e-6 * cm["lr"]:
        raise AssertionError(f"phase4: the card's step differs from the CPU's: {bad}, "
                             f"lr {gm['lr']} vs {cm['lr']}")
    return row


def phase4(tmp, report, *, model_cfg=None, seq_len=2048, global_batch=4):
    """The port's trainer at qwen1.5-0.5b's full width and depth: run A
    trains steps 1-4 with a device pre-codec save every 2 steps (the
    fused pass runs on the trainer's own saves); run B, a fresh model,
    pipeline and manager on the same root, restores step 2 from the PFS
    with L1 dropped and replays steps 3-4. Run B's state must equal run
    A's byte for byte, and so must step 4 restored from the PFS. Before
    run A, one step at the same widths and sequence length (two layers)
    is held against the port's CPU step. Returns the kernel launches
    counted over both runs, and the device digests of run A's step-4
    params (phase 5 holds the served params to them)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointConfig, theta_like
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import deterministic_algorithms, run
    from repro_torch.train import OptConfig, TrainConfig

    t_phase = time.perf_counter()
    cfg = model_cfg or get_config("qwen1.5-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=SEED)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4), remat=True)
    root = tmp / "train"
    ckpt = CheckpointConfig(
        root=str(root), cluster=theta_like(4, 4), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=CHUNK_SIZE, device_precodec=True,
        precodec="none", device=DEVICE,
    )
    log(f"phase4 model: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={cfg.param_dtype} "
        f"compute={cfg.compute_dtype} batch={global_batch}x{seq_len} remat=True")

    def tagged(tag):
        return lambda line: log(f"phase4 {tag} {line}")

    ref = phase4_reference_step(cfg, tcfg, seq_len, report)
    gc.collect()
    reset_counts()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=2, device=DEVICE,
            seed=SEED, log=tagged("A"))
    run_a_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    if a.flush_errors:
        raise AssertionError(f"phase4 flush errors: {a.flush_errors}")
    if not np.isfinite(a.losses).all():
        raise AssertionError(f"phase4 loss is not finite: {a.losses}")
    launches_a = read_counts()
    if launches_a["fused_precodec"] == 0:
        raise AssertionError("phase4: fused_precodec was not launched on the trainer's saves")
    copy = host_copy(a.state)
    digests = device_digests(a.state)
    params_digests = digests[[n.startswith("['params']") for n, _ in leaves(a.state)]]
    cursor = int(a.data.state_tree()["batch_idx"])
    target = {"train": a.state, "data": a.data.state_tree()}

    # step 4 from the PFS, elastic 16 -> 3 ranks, L1 of all 4 saving nodes dropped
    tree, restore4_s, _ = restore_step(root, 4, target)
    assert_equal_to_host(tree["train"], copy, "phase4 restored step 4")
    if not np.array_equal(device_digests(tree["train"]), digests):
        raise AssertionError("phase4: digests of the restored step 4 differ")
    if int(tree["data"]["batch_idx"]) != cursor:
        raise AssertionError("phase4: restored step 4 has another batch cursor")
    del tree, target
    losses_a, step_s, saves = a.losses, a.step_s, a.saves
    del a
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # run B restores step 2 from the PFS: L1 of the 4 saving nodes is gone
    drop_l1(manager(root, theta_like(4, 4))).close()
    t0 = time.perf_counter()
    b = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=0, resume=2, device=DEVICE,
            seed=SEED + 1, log=tagged("B"))
    run_b_s = time.perf_counter() - t0
    if b.restored_step != 2 or b.losses != losses_a[2:]:
        raise AssertionError(f"phase4 replay: restored {b.restored_step}, "
                             f"losses {b.losses} != {losses_a[2:]}")
    if b.restore_read is None or b.restore_read.bytes_read == 0:
        raise AssertionError("phase4: run B did not restore step 2 from the PFS")
    assert_equal_to_host(b.state, copy, "phase4 replayed step 4")
    if not np.array_equal(device_digests(b.state), digests):
        raise AssertionError("phase4: digests of the replayed step 4 differ")
    if int(b.data.state_tree()["batch_idx"]) != cursor:
        raise AssertionError("phase4: the replay ends at another batch cursor")
    restore2_s, replay_s = b.restore_s, b.step_s
    del copy
    with deterministic_algorithms():
        profile = profile_train_step(cfg, tcfg, b.state, b.data)
    del b
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
        profile=profile, reference_step_err=ref["err"],
    )
    row["wall_s"] = time.perf_counter() - t_phase
    report["phase4"] = row
    log(f"phase4 losses {losses_a} finite=True; replayed steps 3-4 {losses_a[2:]}")
    log(f"phase4 step_ms (run A steps 2-4, synchronised, checkpoint in flight)={ms:.3f} "
        f"tokens_per_s={row['tokens_per_s']:.1f}; replay step_ms (run B steps 3-4, no "
        f"checkpoint)={replay_ms:.3f} tokens_per_s={row['replay_tokens_per_s']:.1f}; "
        f"peak_device_bytes={peak} [{report.get('card')}]")
    for st in row["saves"]:
        log(f"phase4 save step {st['step']}: stage_s={st['stage_s']:.4f} "
            f"stage_wait_s={st['stage_wait_s']:.4f} window_s={st['blocking_window_s']:.4f} "
            f"flush_s={st['flush_s']} stored/raw={st['stored_over_raw']:.6f} [{report.get('card')}]")
    log(f"phase4 restore_s: step 2 into run B={restore2_s:.3f} step 4 (check)={restore4_s:.3f}; "
        f"run A {run_a_s:.1f} s, run B {run_b_s:.1f} s, wall {row['wall_s']:.1f} s "
        f"[{report.get('card')}]")
    log("phase4 run B's step 4 equals run A's byte for byte (params, mu, nu, count, step), "
        "device digest for digest, cursor for cursor; so does step 4 restored from the PFS")
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
# the node-local decoded-chunk cache of phase 5's fleet: step 2's and
# step 4's decoded params chunks (2 x 2.48 GB), so the cold start's second
# replica and the swap onto step 4 (a delta on step 2) can hit it
SERVE_CACHE_BYTES = 6 << 30
SWAP_DEADLINE_S = 300.0


def phase5_reference(cfg, report, *, n_layers=2, batch=2, prompt=2048, steps=16):
    """Prefill of ``batch`` x ``prompt`` tokens then ``steps`` greedy
    decode steps of ``cfg`` at its full widths, depth cut to
    ``n_layers``, from one set of weights (from a seed), on the card and
    through the port's CPU, the CPU teacher-forced on the card's tokens:
    every step's logits and the cache after prefill and at the end within
    ``SERVE_REF_TOL``."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

    cfg = cfg.replace(n_layers=n_layers)
    model = get_model(cfg)
    host = tree_to_numpy(model.init(torch.Generator().manual_seed(SEED), "cpu").state_tree())
    prompt_np = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, prompt))
    forced = None
    out = {}
    for dev in (DEVICE, "cpu"):
        params = tree_from_numpy(host, dev)
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = torch.as_tensor(prompt_np.astype(np.int32), device=dev)
            cache, lg = model.prefill(params, {"tokens": tokens}, s_max=prompt + steps)
            logits, caches, toks = [lg.float().cpu()], [[x.float().cpu() for x in cache[:2]]], []
            for i in range(steps):
                tok = lg.argmax(-1)[:, None].to(torch.int32) if forced is None else \
                    forced[i].to(dev)
                toks.append(tok.cpu())
                lg, cache = model.decode_step(params, cache, tok)
                logits.append(lg.float().cpu())
            caches.append([x.float().cpu() for x in cache[:2]])
        sync()
        out[dev] = (logits, caches, time.perf_counter() - t0)
        forced = toks       # the CPU decodes the card's tokens
        del params, cache
    (g_logits, g_caches, g_s), (c_logits, c_caches, c_s) = out[DEVICE], out["cpu"]
    logit_err = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_logits, c_logits)]
    cache_err = [float((a - b).norm() / b.norm())
                 for ga, ca in zip(g_caches, c_caches) for a, b in zip(ga, ca)]
    row = dict(n_layers=n_layers, batch=batch, prompt=prompt, steps=steps, card_s=g_s,
               cpu_s=c_s, logits_err=logit_err, cache_err=cache_err, tol=SERVE_REF_TOL)
    report["phase5_reference"] = row
    log(f"phase5 reference ({cfg.name} widths, {n_layers} layers, batch {batch}x{prompt}, "
        f"{steps} decode steps teacher-forced): card {g_s:.3f} s, cpu {c_s:.3f} s; "
        f"worst logits err {max(logit_err):.3e} of max|logit| (tol {SERVE_REF_TOL['logits']:g}), "
        f"worst cache err {max(cache_err):.3e} relative (tol {SERVE_REF_TOL['cache']:g})")
    if max(logit_err) > SERVE_REF_TOL["logits"] or max(cache_err) > SERVE_REF_TOL["cache"]:
        raise AssertionError(f"phase5: the card's serving differs from the CPU's: "
                             f"logits {logit_err}, cache {cache_err}")
    return row


def meta_train_target(cfg):
    """The structure of the trainer's checkpoint (train state + data
    cursor) on the meta device: a restore reads names, not values."""
    import torch

    from repro_torch.models.transformer import Transformer

    def params():
        return Transformer(cfg, device="meta").state_tree()

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
    from repro_torch.models.transformer import DecodeCache, Transformer
    from repro_torch.serve import FleetConfig, ServeConfig, ServeFleet, Server

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
    fleet = ServeFleet(model, mgr, Transformer(cfg, device="meta").state_tree(), prefix=prefix,
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
    half = new // 2
    uninterrupted = v1[0]
    with torch.inference_mode():
        cache, lg = model.prefill(srv.params, {"tokens": dev_prompt}, s_max=prompt + new)
        tok = lg.argmax(-1)[:, None].to(torch.int32)
        first = []
        for _ in range(half):
            first.append(tok[:, 0])
            lg, cache = model.decode_step(srv.params, cache, tok)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
    if not np.array_equal(torch.stack(first, 1).cpu().numpy(), uninterrupted[:, :half]):
        raise AssertionError("phase5: the decode loop differs from Server.generate")
    snap_root = tmp / "serve_snapshot"
    smgr = manager(snap_root, theta_like(4, 4))
    before = read_counts()["fused_precodec"]
    st = smgr.save(1, srv.snapshot_state(cache) | {"tok": tok})
    smgr.wait()
    if smgr.flush_errors or read_counts()["fused_precodec"] == before:
        raise AssertionError(f"phase5 snapshot: flush errors {smgr.flush_errors} or no "
                             f"fused_precodec launch")
    smgr.close()
    del cache, tok
    target = {"params": Transformer(cfg, device="meta").state_tree(),
              "cache": model.cache_struct(batch, prompt + new),
              "tok": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
    rmgr = drop_l1(manager(snap_root, theta_like(2, 1)))
    t0 = time.perf_counter()
    _, got = rmgr.restore(target)
    sync()
    restore_s = time.perf_counter() - t0
    rmgr.close()
    if not isinstance(got["cache"], DecodeCache) or got["cache"].k.device.type != DEVICE:
        raise AssertionError("phase5: the restored cache is not a DecodeCache on the card")
    fresh = Server(model, got["params"], scfg)
    cache, tok, rest = got["cache"], got["tok"], []
    with torch.inference_mode():
        for _ in range(new - half):
            rest.append(tok[:, 0])
            lg, cache = model.decode_step(fresh.params, cache, tok)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
    if not np.array_equal(torch.stack(rest, 1).cpu().numpy(), uninterrupted[:, half:]):
        raise AssertionError("phase5: the resumed server emitted other tokens")
    fl = st.flush
    row["snapshot"] = dict(stage_s=st.stage_s, window_s=st.encode_time + st.local_time,
                           flush_s=fl.duration if fl else None, restore_s=restore_s,
                           raw_bytes=st.raw_bytes, stored_bytes=st.stored_bytes)
    log(f"phase5 snapshot after {half} tokens ({st.raw_bytes} bytes): "
        f"stage_s={st.stage_s:.4f} window_s={st.encode_time + st.local_time:.4f} "
        f"flush_s={row['snapshot']['flush_s']} restore_s={restore_s:.3f}; the fresh server "
        f"emits the other {new - half} tokens identically [{report.get('card')}]")
    del got, cache, fresh
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
    ap.add_argument("--layers", type=int, default=N_LAYERS,
                    help="depth of phase 2's model state (widths are never cut; "
                         "phases 4 and 5 always run the full depth)")
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

    n_words, n_quant = state_words(args.layers), quantized_values(args.layers)
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
        state, launches2 = phase2(args.layers, Path(tmp), pool, report)
        phase_s["2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches3 = phase3(state, report)
        phase_s["3"] = time.perf_counter() - t0
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches4, step4_digests = phase4(Path(tmp), report)
        phase_s["4"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches5 = phase5(Path(tmp), report, step4_digests)
        phase_s["5"] = time.perf_counter() - t0
    launches = [launches2, launches3, launches4, launches5]
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
