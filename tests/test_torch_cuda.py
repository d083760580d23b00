"""The port's CUDA kernels and device path on the card.

Imports torch and NumPy only, so it runs where JAX is absent. Every test
needs a CUDA device (the kernels have no CPU mode) and skips without
one; on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.kernels.fused.ops import fused_precodec, fused_precodec_plain
from repro_torch.kernels.quantize.ops import quantize, quantize_plain
from repro_torch.utils.treelib import flatten_with_names

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _words(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda", generator=g)


@pytest.mark.parametrize(
    "n,cw",
    [(3 * 2048 + 777, 2048), (1024, 1024), (100_003, 262_144), ((1 << 21) + 5, 1 << 21)],
)
def test_fused_kernel_matches_plain(cuda, n, cw):
    cur = _words(n, n)
    base = cur.clone()
    base[::7] ^= 1
    got = fused_precodec(cur, base, chunk_words=cw)
    ref = fused_precodec_plain(cur, base, chunk_words=cw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_quantize_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn(5 * 4096 + 300, device="cuda", generator=g) * 3).to(dtype)
    x[:128] = 0
    q, s = quantize(x)
    flat = torch.nn.functional.pad(x.float(), (0, (-x.numel()) % 4096))
    rq, rs = quantize_plain(flat.view(-1, 128))
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert not q[0].any() and float(s[0]) == 0.0


def test_wrappers_refuse_unaligned_input(cuda):
    x = _words(4096 + 1, 1)
    with pytest.raises(ValueError, match="aligned"):
        fused_precodec(x[1:], x[1:], chunk_words=1024)


@pytest.mark.parametrize("precodec", ["none", "int8"])
def test_device_round_trip(cuda, tmp_path, precodec):
    rng = np.random.default_rng(0)
    state = {
        "w": torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32)).cuda(),
        "h": torch.from_numpy(rng.standard_normal((40, 130)).astype(np.float32))
        .to(torch.bfloat16).cuda(),
        "flag": torch.from_numpy(rng.random(513) < 0.5).cuda(),
        "step": torch.tensor(1, dtype=torch.int32, device="cuda"),
    }
    cfg = dict(root=str(tmp_path), cluster=theta_like(2, 2), codec="zstd+delta",
               chunk_size=4096, device_precodec=True, precodec=precodec)
    mgr = CheckpointManager(CheckpointConfig(**cfg))
    launches = fused_precodec.launches
    copies = {}
    for step in (1, 2):
        copies[step] = {n: t.cpu().clone() for n, t in flatten_with_names(state)[0]}
        mgr.stage(step, state)
        state["w"][:8].add_(1.0)      # in place, after stage()
        state["step"].add_(1)
        mgr.save(step, state)
    mgr.wait()
    mgr.close()
    assert fused_precodec.launches == launches + 2
    mgr = CheckpointManager(CheckpointConfig(**cfg))
    for step in (1, 2):
        _, tree = mgr.restore(state, step=step)
        for n, t in flatten_with_names(tree)[0]:
            assert t.device.type == "cuda"
            if precodec == "none" or t.dtype not in (torch.float32, torch.bfloat16):
                assert torch.equal(t.cpu(), copies[step][n]), n
    mgr.close()
