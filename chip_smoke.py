#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card (an H100), end to end.

    python3 chip_smoke.py [--layers N]

Phase 0 prints the card and builds the CUDA kernels from the sources in
this checkout (``src/repro_torch/kernels/*/csrc/*.cu``, with ``nvcc``,
into ``build/repro_torch/``).

Phase 1 holds each kernel against its plain PyTorch version on the card,
at the shapes the main path gives it and on constructed edge cases, and
times both. Equality is exact (tolerance zero).

Phase 2 is the main path: the training state of qwen1.5-0.5b at its
published widths (``src/repro/configs/qwen1_5_0_5b.py``: 24 layers,
d_model 1024, d_ff 2816, vocab 151936, untied output, QKV bias) with
AdamW moments, all float32 from a NumPy seed, lives on the card. Three
steps go through ``CheckpointManager.stage``/``save`` with the device
pre-codec (strategy stripe_aligned, codec zstd+delta, 1 MiB chunks,
16 ranks), updating the state in place between ``stage`` and ``save``
as a torch optimizer does; then every step is restored from the PFS on a
3x1 cluster with L1 dropped and compared byte for byte with a host copy.
A second manager saves an int8 anchor and delta, whose restores must
equal the plain quantize followed by the host dequantize, exactly.
``--layers`` cuts the depth (never a width) when a run must be shorter.

Prints the card's name and power limit, per-step numbers, one JSON line
of kernels, and last ``{"ok": true, "device": {...}}``. Exits non-zero
(with no result) without a CUDA device, outside the repository, or when
any check fails. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
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


# -- phase 2 --------------------------------------------------------------


def manager(root, cluster, **kw):
    from repro_torch.core import CheckpointConfig, CheckpointManager

    return CheckpointManager(CheckpointConfig(
        root=str(root), cluster=cluster, strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=CHUNK_SIZE, device_precodec=True,
        delta_every=4, device=DEVICE, **kw,
    ))


def restore_step(root, step, target):
    from repro_torch.core import theta_like

    mgr = manager(root, theta_like(3, 1))
    for n in range(4):
        mgr.local.drop_node(n)        # L1 of the 4 saving nodes is gone
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


def phase2(n_layers, tmp, pool, report):
    import torch

    from repro_torch.core import theta_like
    from repro_torch.core.precodec import _dequantize_leaf, _is_float_leaf
    from repro_torch.kernels.fused.ops import fused_precodec
    from repro_torch.kernels.quantize.ops import TILE, quantize, quantize_plain
    from repro_torch.kernels.common import pad_to_multiple

    t0 = time.perf_counter()
    state = make_state(n_layers, DEVICE, pool)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves(state))
    log(f"phase2 state: qwen1.5-0.5b n_layers={n_layers} leaves={len(leaves(state))} "
        f"bytes={n_bytes} built_s={time.perf_counter() - t0:.3f}")
    report["state"] = dict(n_layers=n_layers, bytes=n_bytes, leaves=len(leaves(state)))

    fused_precodec.launches = 0
    quantize.launches = 0

    # -- precodec none: anchor, top-4-layer fine-tune, full update --------
    root = tmp / "none"
    mgr = manager(root, theta_like(4, 4))
    copies, stats = {}, {}
    updates = {1: fine_tune_top_layers, 2: update_everything, 3: None}
    for step in (1, 2, 3):
        copies[step] = host_copy(state)
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
        del tree
        rows.append(step_row(stats[step], secs, rr))
        log("phase2 none " + json.dumps(rows[-1]))
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
    expect, stats = {}, {}
    for step in (1, 2):
        expect[step] = expected_int8(state)
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
        for (name, got), (_, want) in zip(leaves(tree), expect[step]):
            if isinstance(want, tuple):
                want = _dequantize_leaf(want[0], want[1], got)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"int8 step {step}: leaf {name} differs")
        del tree
        rows.append(step_row(stats[step], secs, rr))
        log("phase2 int8 " + json.dumps(rows[-1]))
    report["steps_int8"] = rows
    shutil.rmtree(root)

    launches = {"fused_precodec": fused_precodec.launches, "quantize": quantize.launches}
    log(f"phase2 launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=N_LAYERS,
                    help="depth of the model state (widths are never cut)")
    args = ap.parse_args(argv)

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

    phase1_fused(state_words(args.layers), report)
    phase1_quantize(quantized_values(args.layers), report)

    out_dir = ROOT / "chiprun_out"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            ThreadPoolExecutor(8) as pool:
        launches = phase2(args.layers, Path(tmp), pool, report)

    kernels = [
        dict(name="fused_precodec", route="cuda",
             source="src/repro_torch/kernels/fused/csrc/fused_precodec.cu",
             replaces="src/repro/kernels/fused/fused.py:36",
             launches=launches["fused_precodec"],
             max_abs_err=report["fused"]["max_abs_err"], ms=report["fused"]["ms"],
             plain_ms=report["fused"]["plain_ms"], bound_ms=report["fused"]["bound_ms"],
             bound_by=report["fused"]["bound_by"], library_ms=None),
        dict(name="quantize", route="cuda",
             source="src/repro_torch/kernels/quantize/csrc/quantize.cu",
             replaces="src/repro/kernels/quantize/quantize.py:20",
             launches=launches["quantize"],
             max_abs_err=report["quantize"]["max_abs_err"], ms=report["quantize"]["ms"],
             plain_ms=report["quantize"]["plain_ms"], bound_ms=report["quantize"]["bound_ms"],
             bound_by=report["quantize"]["bound_by"], library_ms=None),
    ]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total_s={report['total_s']:.1f}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
