"""Run one cell of the benchmark of ``repro_torch`` on one CUDA device.

    python3 ckpt_bench/run.py --workload whisper-small.save --seed 7 --seconds 30 --trace 0

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, the bytes the run wrote
(``written_bytes``) and, last, each number that decides ``correct``
beside its limit (``checks``), which also end standard error. Without a
CUDA device, without the program's sources beside the benchmark, or
with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with another code than 0.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# read when cuBLAS makes its handle, so before any product; caches of
# compiled code stay in the checkout, at fixed paths
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e!r})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside the benchmark under {ROOT}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from ckpt_bench import bench

    bench_json = bench.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench_json["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = bench.load_cell(args.workload, bench_json)
    result = bench.run_cell(cell, args.seed, args.seconds, traced=bool(args.trace),
                            device="cuda", t_process=T_PROCESS, log=print)
    found = bench.forbidden_modules()
    if found:
        print(f"refusing to report: modules loaded in the run's process: {found}",
              file=sys.stderr)
        return 4
    card = power_limit()
    result["device"]["card"] = card
    w = result["written_bytes"]
    print(f"written_bytes l1={w['l1']} pfs={w['pfs']} [{card}]")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
