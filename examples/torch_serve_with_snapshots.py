"""Batched serving with live-state snapshots through the checkpoint engine,
in the PyTorch port: the counterpart of ``examples/serve_with_snapshots.py``.

A dense model (qwen1.5-0.5b smoke config, a KV cache) and a recurrent
one (RecurrentGemma smoke config: per-request RG-LRU state and ring KV
caches) each serve a batch; mid-generation, the serving state (params,
cache, the next token) is checkpointed asynchronously; a second server
restores it from the PFS and continues, emitting exactly the tokens the
first one would have. The restore's template comes from the model
(``param_struct``, ``cache_struct``: the meta device, no memory).

    PYTHONPATH=src python examples/torch_serve_with_snapshots.py --device cpu

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.models import get_model
from repro_torch.serve import ServeConfig, Server


def serve_and_resume(arch: str, device: str) -> None:
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(7), device).state_tree()
    server = Server(model, params, ServeConfig(max_new_tokens=6, s_max=32))
    prompts = np.tile(np.arange(8, dtype=np.int32)[None], (4, 1))
    print(f"[{arch}] server.generate       :", server.generate({"tokens": prompts})[0][0])

    # serve 3 tokens, snapshot, then 3 more
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.as_tensor(prompts, device=device)}, s_max=32)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        first, snap = [], None
        for i in range(6):
            first.append(tok[:, 0].cpu().numpy())
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            if i == 2:
                snap = server.snapshot_state(cache) | {"tok": tok}
    first = np.stack(first, 1)
    print(f"[{arch}] continuous generation :", first[0])
    np.testing.assert_array_equal(first, server.generate({"tokens": prompts})[0])

    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(CheckpointConfig(
            root=root, cluster=theta_like(2, 2), strategy="stripe_aligned", device=device))
        mgr.save(1, snap)
        mgr.wait()
        assert not mgr.flush_errors
        mgr.close()
        # a fresh server on another geometry, L1 gone: the snapshot comes from the PFS
        mgr = CheckpointManager(CheckpointConfig(
            root=root, cluster=theta_like(3, 1), strategy="stripe_aligned", device=device))
        for node in range(2):
            mgr.local.drop_node(node)
        target = {"params": model.param_struct(), "cache": model.cache_struct(4, 32),
                  "tok": torch.empty((4, 1), dtype=torch.int32, device="meta")}
        _, restored = mgr.restore(target)
        mgr.close()

    resumed_server = Server(model, restored["params"], server.cfg)
    r_cache, r_tok = restored["cache"], restored["tok"]
    resumed = list(first[:, :3].T)
    with torch.inference_mode():
        for _ in range(3):
            resumed.append(r_tok[:, 0].cpu().numpy())
            logits, r_cache = model.decode_step(resumed_server.params, r_cache, r_tok)
            r_tok = logits.argmax(-1)[:, None].to(torch.int32)
    resumed = np.stack(resumed, 1)
    print(f"[{arch}] resumed-from-snapshot :", resumed[0])
    np.testing.assert_array_equal(first, resumed)
    print(f"[{arch}] snapshot resume emits identical tokens")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = ap.parse_args().device
    for arch in ("qwen1.5-0.5b", "recurrentgemma-2b"):
        serve_and_resume(arch, device)
