"""End-to-end driver of the PyTorch port: train a ~0.5B-family model
(reduced) with async aggregated checkpointing, inject a mid-flush crash
AND a node loss, then restart elastically on a smaller cluster geometry;
training resumes bit-exactly. The port of ``examples/train_with_failures.py``.

    PYTHONPATH=src python examples/torch_train_with_failures.py --device cpu

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse
import itertools
import os
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.train import deterministic_algorithms
from repro_torch.models import get_model
from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state
from repro_torch.utils.convert import copy_tree_, tree_to_numpy
from repro_torch.utils.treelib import tree_leaves

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = ap.parse_args().device
if device == "cuda":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

cfg = get_smoke_config("qwen1.5-0.5b")
model = get_model(cfg)
data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
tcfg = TrainConfig(opt=OptConfig(lr=1e-3, total_steps=40))
step_fn = build_train_step(model, tcfg)

with tempfile.TemporaryDirectory() as root, deterministic_algorithms():
    data = SyntheticTokens(data_cfg, device=device)
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0), tcfg, device)

    # fault: the active backend dies mid-flush on the FIRST checkpoint
    crash_after = itertools.count()

    def moody_backend(_w):
        if next(crash_after) < 2:  # first flush (step 4) dies mid-write
            raise IOError("injected: backend crash mid-flush")

    mgr = CheckpointManager(
        CheckpointConfig(root=root, cluster=theta_like(4, 2),
                         strategy="stripe_aligned",
                         partner_replication=True, device=device),
        fault_hook=moody_backend,
    )
    for i in range(1, 9):
        state, metrics = step_fn(state, data.next())
        print(f"step {i} loss {float(metrics['loss']):.4f}")
        if i % 4 == 0:
            mgr.save(i, {"train": state, "data": data.state_tree()})
    mgr.wait()
    print("flush errors (expected: step 4 injected):", mgr.flush_errors)
    # ground truth: two more steps from the saved state (in place)
    saved_cursor = data.state_tree()
    d_truth = SyntheticTokens(data_cfg, state=saved_cursor, device=device)
    truth = state
    for _ in range(2):
        truth, _ = step_fn(truth, d_truth.next())
    mgr.close()

    # node 2's local storage dies too; restart on a 2-node cluster
    mgr2 = CheckpointManager(
        CheckpointConfig(root=root, cluster=theta_like(2, 1),
                         strategy="file_per_process", device=device)
    )
    mgr2.local.drop_node(2)
    fresh = init_train_state(model, torch.Generator(device=device).manual_seed(1), tcfg, device)
    d2 = SyntheticTokens(data_cfg, device=device)
    step, restored = mgr2.restore({"train": fresh, "data": d2.state_tree()})
    print(f"restored step {step} on the shrunken cluster")
    copy_tree_(fresh, restored["train"])
    d2.load_state(restored["data"])
    for _ in range(2):
        fresh, _ = step_fn(fresh, d2.next())
    same = all(
        a.tobytes() == b.tobytes()
        for a, b in zip(tree_leaves(tree_to_numpy(truth)), tree_leaves(tree_to_numpy(fresh)))
    )
    print("bit-exact resume after crash + node loss + reshard:", same)
    assert same
    mgr2.close()
