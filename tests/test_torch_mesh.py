"""The port's mesh layer: ``make_host_mesh``, ``make_train_step`` and a
mesh-placed state through the checkpoint path.

On a gloo mesh of one process (made in this process and destroyed
after each test) ``make_train_step`` equals ``build_train_step`` bit
for bit, and a state placed on it stores the same bytes and digests as
the same state of plain tensors. The multi-process cases run this file
as a script in a subprocess with a timeout, one gloo process a rank on
a ``FileStore`` (``python tests/test_torch_mesh.py step 2x2 <tmpdir>``):
``step`` holds one step of ``make_train_step`` on a (2, 1), (1, 2) or
(2, 2) mesh to ``build_train_step`` on the whole batch (loss
``rel=1e-5``, parameters ``rtol=2e-4, atol=2e-5``: the reference's
``test_grad_accumulation_equivalence`` tolerances) with every leaf's
local shard of the shape its placements give; ``run`` drives the loop's
saves on a 2x2 mesh (rank 0 alone writes), then a second run restores
step 2 and replays step 3 bit for bit. Torch only.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

import repro_torch.core as T
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import run
from repro_torch.models import get_model
from repro_torch.models.sharding import is_spec, local_shard, place, to_placements
from repro_torch.train import (
    OptConfig, TrainConfig, build_train_step, init_train_state, make_train_step,
    train_state_specs,
)
from repro_torch.utils.convert import whole_tensor
from repro_torch.utils.treelib import flatten_with_names, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def host_mesh():
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_make_host_mesh_on_the_cpu(host_mesh):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)


def test_make_host_mesh_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh("cuda")
    assert not dist.is_initialized()   # no group was started for it


def assert_same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "xlstm-350m"])
def test_make_train_step_on_one_device_is_build_train_step(host_mesh, arch):
    """Two steps of a dense, an MoE and a recurrent smoke config: the
    loss, grad norm, lr and every state leaf bit for bit; every leaf a
    DTensor placed by ``train_state_specs``."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                           device="cpu")
    batches = [data.next() for _ in range(2)]
    want = init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
    fn, sspecs, _ = make_train_step(model, tcfg, host_mesh, batches[0])
    got = place(init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu"),
                host_mesh, sspecs)
    step = build_train_step(model, tcfg)
    for batch in batches:
        want, wm = step(want, batch)
        got, gm = fn(got, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert_same_bits(gm[k], wm[k])
    specs = tree_leaves(sspecs, is_leaf=is_spec)
    for (name, x), y, spec in zip(flatten_with_names(got)[0], tree_leaves(want), specs):
        assert isinstance(x, DTensor), name
        assert tuple(x.placements) == to_placements(spec, host_mesh), name
        assert_same_bits(x.to_local(), y.detach())


PATHS = {
    "host": {},
    "host_zstd_delta": dict(codec="zstd+delta", chunk_size=8192),
    "device_precodec": dict(codec="zstd+delta", chunk_size=8192, device_precodec=True),
    "int8": dict(precodec="int8"),
}


def _stored(root):
    """Every stored blob under ``root`` by path, and the manifests."""
    blobs, manifests = {}, {}
    for path in sorted(Path(root).rglob("*")):
        if path.is_file():
            rel = str(path.relative_to(root))
            (manifests if path.suffix == ".json" else blobs)[rel] = path.read_bytes()
    return blobs, manifests


@pytest.mark.parametrize("path", list(PATHS))
def test_mesh_placed_state_stores_the_bytes_of_its_plain_twin(host_mesh, tmp_path, path):
    """A train state placed on the 1x1 mesh and the same state of plain
    tensors, each saved twice (steps 1 and 2, the second a delta where
    the codec has one) through ``CheckpointManager`` on the CPU's plain
    kernel versions: the same blobs byte for byte, the same leaf table,
    chunk digests and CRCs. Restoring into the DTensor target gives plain
    tensors equal to the plain twin's restore."""
    model = get_model(get_smoke_config("qwen1.5-0.5b"))
    tcfg = TrainConfig()
    mk = lambda: init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
    states = {"plain": mk(), "mesh": place(mk(), host_mesh,
                                           train_state_specs(model, host_mesh, tcfg))}
    stored, restored = {}, {}
    for kind, state in states.items():
        root = tmp_path / kind
        mgr = T.CheckpointManager(T.CheckpointConfig(
            root=str(root), cluster=T.theta_like(2, 2), device="cpu", **PATHS[path]))
        for step in (1, 2):
            if step == 2:
                with torch.no_grad():
                    whole_tensor(state["params"]["embed"])[0].add_(1.0)
            full = {"train": state}
            mgr.stage(step, full)
            mgr.save(step, full)
        mgr.wait()
        mgr._l0 = None
        got, restored[kind] = mgr.restore({"train": state})
        assert got == 2
        mgr.close()
        stored[kind] = _stored(root)
    assert stored["plain"][0] and stored["plain"][1]
    assert stored["plain"][0] == stored["mesh"][0]
    assert stored["plain"][1] == stored["mesh"][1]
    for a, b in zip(tree_leaves(restored["plain"]), tree_leaves(restored["mesh"])):
        assert not isinstance(b, DTensor)
        assert_same_bits(a, b)


def _worker(case, shape, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), case, shape, str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"ok {case}" in out.stdout


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_mesh_step_matches_the_whole_batch(tmp_path, shape):
    _worker("step", shape, tmp_path)


def test_run_on_a_2x2_mesh_saves_from_rank_0_and_resumes_bit_exact(tmp_path):
    _worker("run", "2x2", tmp_path)


# -- the multi-process cases (this file run as a script) ---------------------

ARCH = "tinyllama-1.1b"


def _case_step(mesh, tmp):
    model = get_model(get_smoke_config(ARCH))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    batch = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=8),
                            device="cpu").next()
    want = init_train_state(model, torch.Generator().manual_seed(1), tcfg, "cpu")
    want, wm = build_train_step(model, tcfg)(want, batch)
    fn, sspecs, _ = make_train_step(model, tcfg, mesh, batch)
    state = place(init_train_state(model, torch.Generator().manual_seed(1), tcfg, "cpu"),
                  mesh, sspecs)
    state, m = fn(state, batch)
    assert math.isclose(float(m["loss"]), float(wm["loss"]), rel_tol=1e-5), (m, wm)
    specs = tree_leaves(sspecs, is_leaf=is_spec)
    for (name, x), (_, y), spec in zip(flatten_with_names(state)[0],
                                       flatten_with_names(want)[0], specs):
        pl = to_placements(spec, mesh)
        assert tuple(x.placements) == pl, name
        assert x.to_local().shape == local_shard(y, mesh, pl).shape, name
        got = whole_tensor(x).detach().float().numpy()
        np.testing.assert_allclose(got, y.detach().float().numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def _case_run(mesh, tmp):
    cfg = get_smoke_config(ARCH)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3))
    ckpt = T.CheckpointConfig(root=os.path.join(tmp, "ckpt"), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192, device_precodec=True,
                              device="cpu")
    quiet = lambda _: None
    a = run(cfg, data_cfg, tcfg, ckpt, steps=3, ckpt_every=1, device="cpu", log=quiet,
            save_last=True, mesh=mesh)
    if dist.get_rank() == 0:
        assert [s.step for s in a.saves] == [1, 2, 3] and not a.flush_errors
    b = run(cfg, data_cfg, tcfg, ckpt, steps=3, ckpt_every=0, resume=2, device="cpu",
            log=quiet, mesh=mesh)
    assert b.restored_step == 2 and b.losses == a.losses[2:], (a.losses, b.losses)
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(whole_tensor(x), whole_tensor(y))


def _rank(rank, world, shape, case, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        {"step": _case_step, "run": _case_run}[case](mesh, tmp)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv):
    case, shape, tmp = argv
    shape = tuple(int(n) for n in shape.split("x"))
    world = math.prod(shape)
    mp.spawn(_rank, args=(world, shape, case, tmp), nprocs=world, join=True)
    print(f"ok {case} {shape}")


if __name__ == "__main__":
    main(sys.argv[1:])
