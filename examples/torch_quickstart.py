"""Quickstart of the PyTorch port: aggregated asynchronous checkpointing
in 60 lines. The port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Builds a FlushPlan with the paper's §3 stripe-aligned strategy.
2. Prices the same plan at Theta scale on the simulator (Fig. 2 setup).
3. Saves/restores a real tree of tensors through the multi-level engine —
   including an elastic restore on a *different* cluster geometry and a
   partial (params-only) restore through the columnar read planner.

Without ``--device`` the state lives on the CUDA card (and the managers
raise without one); restored leaves land on the same device.
"""
import argparse
import tempfile

import torch

from repro_torch.core import (
    CheckpointConfig,
    CheckpointManager,
    count_false_sharing,
    default_codec_impl,
    make_plan,
    simulate_flush,
    theta_like,
)

GiB = 1 << 30

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device

# --- 1. plan: who writes what where -------------------------------------
cluster = theta_like(n_nodes=8, procs_per_node=4)
sizes = [1 * GiB] * cluster.world_size
plan = make_plan("stripe_aligned", cluster, sizes)
print(f"strategy={plan.strategy}  files={plan.n_files}  "
      f"writes={len(plan.writes)}  gather_bytes={plan.network_bytes()}")
print(f"leaders={plan.leaders.leaders}")
print(f"false sharing: {count_false_sharing(plan)['stripes_shared']} shared stripes")

# --- 2. price it on the modeled Theta (paper Fig. 2) ---------------------
for strat in ("file_per_process", "posix", "mpiio", "stripe_aligned"):
    rep = simulate_flush(
        make_plan(strat, cluster, sizes, chunk_stripes=64), io_threads=4
    )
    print(f"{strat:18s} local {rep.local_bw/1e9:7.1f} GB/s   "
          f"flush {rep.flush_bw/1e9:6.1f} GB/s   files {rep.n_files}")

# --- 3. the real engine: save + elastic/partial restore ------------------
# chunk-framed compression works everywhere: zstandard when installed,
# the stdlib-zlib fallback otherwise (recorded in the manifest)
codec = "zstd"

w = torch.arange(1 << 18, dtype=torch.float32, device=device)
state = {"params": {"w": w}, "step": torch.tensor(3, dtype=torch.int32, device=device)}
with tempfile.TemporaryDirectory() as root:
    mgr = CheckpointManager(
        CheckpointConfig(root=root, cluster=cluster, strategy="stripe_aligned",
                         codec=codec, device=device)
    )
    st = mgr.save(1, state)
    mgr.wait()
    mgr.close()
    print(f"saved {st.raw_bytes/1e6:.1f} MB -> {st.stored_bytes/1e6:.1f} MB "
          f"(local {st.local_time*1e3:.1f} ms, codec={codec}, "
          f"backend={default_codec_impl()})")

    # elastic restart: the machine shrank to 3x1, L1 is gone — the PFS
    # checkpoint restores through one aggregated ReadPlan.
    mgr2 = CheckpointManager(
        CheckpointConfig(root=root, cluster=theta_like(3, 1), device=device)
    )
    for n in range(cluster.n_nodes):
        mgr2.local.drop_node(n)
    step, restored = mgr2.restore(
        {"params": {"w": torch.zeros(1 << 18)}, "step": torch.tensor(0, dtype=torch.int32)}
    )
    assert step == 1 and int(restored["step"]) == 3
    assert restored["params"]["w"].device.type == torch.device(device).type
    assert torch.equal(restored["params"]["w"], w)
    rr = mgr2.last_read_result
    print(f"elastic restore OK on 3x1 onto {device} "
          f"({rr.n_reads} ranged reads, {rr.bytes_read/1e6:.1f} MB)")

    # partial restore: just the params subtree (the serving workload)
    _, params = mgr2.restore_subtree({"w": torch.zeros(1 << 18)}, "['params']")
    assert torch.equal(params["w"].to(device), w)
    mgr2.close()
    print("partial (params-only) restore OK")
