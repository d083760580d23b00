"""The benchmark's own tests (``python -m pytest ckpt_bench/tests``).

On the CPU they run the cells at smoke sizes: every width cut to a few
dozen, float32 compute, 64 KiB chunks on a 2 x 2 cluster. Tests marked
``gpu`` need a CUDA device and skip without one.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2_147_483_659   # above 2**31


def smoke_cell(name: str):
    """Cell ``name`` of BENCHMARK.json at smoke sizes."""
    from ckpt_bench import bench

    cell = bench.load_cell(name)
    cfg = dict(cell.cfg, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=256,
               compute_dtype="float32")
    if cfg["family"] == "audio":
        cfg.update(d_ff=128, enc_seq=12)
    cfg["checkpoint"] = dict(cfg["checkpoint"], chunk_size=64 * 1024, nodes=2, ppn=2)
    cell.cfg = cfg
    cell.traffic = dict(cell.traffic, global_batch=4, seq_len=16)
    return cell


def run_smoke(name: str, seconds: float = 1.0, seed: int = SEED, **kw):
    from ckpt_bench import bench

    return bench.run_cell(smoke_cell(name), seed, seconds, device="cpu",
                          log=lambda *a, **k: None, **kw)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
