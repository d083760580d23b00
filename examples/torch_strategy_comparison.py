"""Reproduce the paper's evaluation (Figs 1-2) + §3 proposal in one run, on
the PyTorch port. The port of ``examples/strategy_comparison.py``.

    PYTHONPATH=src python examples/torch_strategy_comparison.py [--nodes 64]

Prints the two figures as text tables at one scale point and the
aggregate verdicts the paper draws from them.
"""
import argparse

from repro_torch.core import make_plan, simulate_flush, theta_like
from repro_torch.utils import fmt_bw

GiB = 1 << 30


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--ppn", type=int, default=8)
    args = ap.parse_args()

    cluster = theta_like(args.nodes, args.ppn)
    sizes = [GiB] * cluster.world_size
    print(f"{args.nodes} nodes x {args.ppn} ppn, 1 GiB/rank "
          f"({cluster.world_size} GiB total), Lustre-like PFS\n")
    print(f"{'strategy':20s} {'local phase':>14s} {'async flush':>14s} "
          f"{'files':>7s} {'md ops':>7s} {'gather':>10s} {'lock eff':>9s}")
    reports = {}
    for strat, kw in [
        ("file_per_process", {}),
        ("posix", {}),
        ("mpiio", {"chunk_stripes": 64}),
        ("stripe_aligned", {"pipeline_chunk": 256 << 20}),
        ("gio_sync", {"chunk_stripes": 64}),
    ]:
        plan = make_plan(strat, cluster, sizes, **kw)
        rep = simulate_flush(plan, io_threads=4)
        reports[strat] = rep
        print(f"{strat:20s} {fmt_bw(rep.local_bw):>14s} "
              f"{fmt_bw(rep.flush_bw):>14s} {rep.n_files:7d} "
              f"{rep.metadata_ops:7d} {rep.network_bytes/GiB:9.1f}G "
              f"{rep.pfs_lock_eff:9.3f}")

    fpp = reports["file_per_process"]
    s3 = reports["stripe_aligned"]
    print("\npaper claims, checked:")
    print(f"  Fig1: VELOC local phase >> GIO direct: "
          f"{fpp.local_bw / reports['gio_sync'].local_bw:.1f}x")
    print(f"  Fig2: posix << fpp (false sharing): "
          f"{fpp.flush_bw / reports['posix'].flush_bw:.2f}x down")
    print(f"  Fig2: mpiio << fpp (collective rounds): "
          f"{fpp.flush_bw / reports['mpiio'].flush_bw:.2f}x down")
    print(f"  §3: stripe-aligned within {100 * (1 - s3.flush_bw / fpp.flush_bw):.1f}% "
          f"of fpp flush at {fpp.n_files}x fewer files "
          f"({s3.metadata_ops} vs {fpp.metadata_ops} metadata ops)")


if __name__ == "__main__":
    main()
