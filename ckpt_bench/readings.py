"""Readings that the limits of ``correct`` are set from, many seeds in one
process (the benchmark's own runs do not run this).

    python3 ckpt_bench/readings.py --workload whisper-small.save --seeds 11,12,13 \\
        [--control fp8] [--control bf16_params] [--fault half_batch] \\
        [--recurrent-std 0.0625] [--out FILE]

For each seed, at the cell's own sizes: the program's first steps (its
step from the seed's parameters on the seed's batches, as the window's
set-up drives it) against the float32 reference. The controls, each in
the program's place: ``fp8``, the reference with float8 matrix products
(e4m3, gradients e5m2), one step below the bfloat16 products that the
configuration states; ``bf16_params``, the program on its own path one
step below the float32 parameters and optimizer state that it states
(``param_dtype`` bfloat16, its moments following). ``--fault
half_batch``: the reference with half of each batch left out.
``--witness``: the program with float32 products, a second witness of
where a gap comes from. ``--recurrent-std``: draw the sLSTM's recurrent
kernels ``r`` from a normal law of that deviation, where the cell starts
them at zero. Prints one JSON line per seed and side with the numbers
of :func:`ckpt_bench.check.step_numbers`.
"""
import argparse
import gc
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="append", default=[], choices=["bf16_params", "fp8"])
    ap.add_argument("--fault", action="append", default=[], choices=["half_batch"])
    ap.add_argument("--witness", action="store_true",
                    help="also the program with float32 products (a second witness)")
    ap.add_argument("--recurrent-std", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from ckpt_bench import bench, check
    from ckpt_bench.inputs import make_batch, make_params
    from ckpt_bench.reference.train import train_steps

    cell = bench.load_cell(args.workload)
    cfg, traffic = cell.cfg, cell.traffic
    ref = importlib.import_module(f"ckpt_bench.reference.{cfg['reference']}")
    dev = torch.device(args.device)
    n = 3
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        batches = [make_batch(cfg, traffic, seed, j, dev) for j in range(n)]
        specs = ref.param_specs(cfg)
        if args.recurrent_std is not None:
            for blk in specs.get("blocks", []):
                if "r" in blk:
                    blk["r"] = (blk["r"][0], "normal", args.recurrent_std)
        params = make_params(specs, seed, dev)

        def program(cfg):
            got = bench.program_readings(cfg, params, batches, dev)
            gc.collect()
            return got

        sides = {"program": program(cfg)}
        want = train_steps(ref, cfg, params, batches, cfg["optimizer"])
        if args.witness:
            sides["witness_f32"] = program(dict(cfg, compute_dtype="float32"))
        if "bf16_params" in args.control:
            sides["control_bf16_params"] = program(dict(cfg, param_dtype="bfloat16"))
        if "fp8" in args.control:
            sides["control_fp8"] = train_steps(ref, cfg, params, batches, cfg["optimizer"],
                                               precision="fp8")
        if "half_batch" in args.fault:
            sides["fault_half_batch"] = train_steps(ref, cfg, params, batches, cfg["optimizer"],
                                                    rows=traffic["global_batch"] // 2)
        for side, r in sides.items():
            numbers, details = check.step_numbers(r, want)
            row = {"seed": seed, "side": side, **numbers,
                   "recurrent_std": args.recurrent_std,
                   "global_norm": r.global_norm, "ref_global_norm": want.global_norm,
                   "worst_grad_leaf": details["worst_grad_leaf"],
                   "worst_diff_leaf": details["worst_diff_leaf"],
                   "worst_change_leaf": details["worst_change_leaf"],
                   "top_grad_leaves": sorted(details["grad_gaps"].items(),
                                             key=lambda kv: -kv[1])[:4],
                   "unmoved": details["unmoved_leaves"], "losses": r.losses,
                   "ref_losses": want.losses}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del params, batches, want, sides
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
