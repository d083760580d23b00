"""The port's optimizer, train step, pipeline and launcher.

Against the JAX reference on the CPU: ``lr_at``, ``adamw_update`` and
full train steps (``jax.jit(build_train_step(...))`` with no mesh, on
the reference's own batches, fed to the port as NumPy arrays; the port
steps through ``make_train_step`` on a 1x1 gloo mesh, as the reference's
launcher does, since the reference's own ``make_train_step`` does not
run under jax 0.9). Then the
port's own invariants (ports of ``tests/test_train.py`` and
``tests/test_launcher.py``): the loss decreases, the pipeline replays,
save -> restore -> continue is bit-exact with and without the device
pre-codec, and the CLI resumes. Last, train states cross between the
packages through each one's ``CheckpointManager``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as R
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import get_model as ref_get_model
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import adamw_update as ref_adamw_update
from repro.train import build_train_step as ref_build_train_step
from repro.train import init_train_state as ref_init_train_state
from repro.train import lr_at as ref_lr_at
import repro_torch.core as T
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import deterministic_algorithms, run
from repro_torch.models import get_model
from repro_torch.models.sharding import place
from repro_torch.train import (
    OptConfig,
    TrainConfig,
    adamw_update,
    build_train_step,
    init_train_state,
    lr_at,
    make_train_step,
)
from repro_torch.utils.convert import copy_tree_, train_state_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["qwen1.5-0.5b", "tinyllama-1.1b"]
# the families beside the dense one: MoE FFN (top-2 of 8, shared
# experts) and VLM patch inputs
MOE_VLM = ["qwen2-moe-a2.7b", "llava-next-mistral-7b"]


def data_kw(arch):
    """The data config's fields for ``arch``'s smoke config: a VLM
    batch also draws patches."""
    cfg = get_smoke_config(arch)
    return dict(n_patches=cfg.n_patches, d_model=cfg.d_model, family=cfg.family)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def named(tree):
    return flatten_with_names(tree)[0]


def assert_bytes_equal(a, b):
    fa, fb = named(a), named(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n


def assert_states_equal(a, b):
    """Two port train states, bit for bit."""
    assert_bytes_equal(tree_to_numpy(a), tree_to_numpy(b))


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture
def host_mesh():
    """``make_host_mesh("cpu")``: a 1x1 mesh on a gloo group of this
    process, destroyed after the test."""
    mesh = make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


# -- schedule and optimizer ------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=20, total_steps=250, schedule=schedule)
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray(ref_lr_at(RefOptConfig(**kw), jnp.asarray(steps)))
    got = lr_at(OptConfig(**kw), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    """One update on given grads from non-zero moments, clipped and not:
    float32 rounding only."""
    r = np.random.default_rng(11)
    shapes = {"a": (64, 33), "b": {"c": (17,), "d": (3, 5, 7)}}
    mk = lambda scale: jax.tree_util.tree_map(
        lambda s: (scale * r.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    params, grads, mu = mk(1.0), mk(0.3), mk(0.01)
    nu = jax.tree_util.tree_map(np.abs, mk(1e-3))
    opt = {"mu": mu, "nu": nu, "count": np.array(6, np.int32)}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip)
    want_p, want_opt, want_m = ref_adamw_update(
        grads, jax.tree_util.tree_map(jnp.asarray, opt), params, RefOptConfig(**kw))

    from repro_torch.utils.convert import tree_from_numpy

    p_t, g_t, opt_t = (tree_from_numpy(x, "cpu") for x in (params, grads, opt))
    got_m = adamw_update(g_t, opt_t, p_t, OptConfig(**kw))
    assert int(opt_t["count"]) == 7 and opt_t["count"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=1e-6), k
    for got, want in ((p_t, want_p), (opt_t["mu"], want_opt["mu"]), (opt_t["nu"], want_opt["nu"])):
        for (n, x), (_, y) in zip(named(tree_to_numpy(got)), named(to_np(want))):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7, err_msg=n)


# -- train steps against jax.jit(build_train_step) ---------------------------


@pytest.fixture(scope="module")
def ref_steps():
    """Per arch: the reference's jitted step, its initial state and
    three batches, with the states it reaches and its metrics."""
    out = {}
    for arch in DENSE + MOE_VLM:
        tcfg = RefTrainConfig(opt=RefOptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
        model = ref_get_model(ref_smoke_config(arch))
        step = jax.jit(ref_build_train_step(model, tcfg))
        state = ref_init_train_state(model, jax.random.PRNGKey(0), tcfg)
        data = RefSyntheticTokens(RefDataConfig(vocab_size=256, seq_len=32, global_batch=4,
                                                **data_kw(arch)))
        states, metrics, batches = [to_np(state)], [], []
        for _ in range(3):
            batches.append(to_np(data.next()))
            state, m = step(state, batches[-1])
            states.append(to_np(state))
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = dict(step=step, states=states, metrics=metrics, batches=batches)
    return out


@pytest.mark.parametrize("arch", DENSE + MOE_VLM)
def test_train_steps_match_reference(arch, ref_steps, host_mesh):
    """Three steps on the reference's batches (lr 5e-3, then 1e-2).

    Each step starts from the reference's state before it and is held to
    the reference's metrics (rel 1e-5) and next state. AdamW divides each
    gradient element by its own magnitude, so where a gradient element is
    near ``eps`` (1e-8) its float32 rounding, which differs between the
    packages, moves the element's step by a visible fraction of lr
    (measured: 0.045 lr in one w_gate element of qwen's smoke config).
    So each parameter is held to 0.1 lr and each leaf's update to 1e-3 of
    its norm, and mu and nu to 1e-4 of their largest element. The port's
    own state is not carried from step to step in that check (after three
    free steps one embedding element differs by 0.011, about lr); the
    free-running losses are held separately, where single elements
    average out."""
    ref = ref_steps[arch]
    model = get_model(get_smoke_config(arch))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    step, specs, _ = make_train_step(model, tcfg, host_mesh, torch_batch(ref["batches"][0]))
    placed = lambda tree: place(train_state_from_numpy(tree, model, "cpu"), host_mesh, specs)
    free = placed(ref["states"][0])
    for i in range(3):
        state = placed(ref["states"][i])
        state, m = step(state, torch_batch(ref["batches"][i]))
        want = ref["metrics"][i]
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(want[k], rel=1e-5), (i, k)
        got, prev, nxt = tree_to_numpy(state), ref["states"][i], ref["states"][i + 1]
        assert int(got["step"]) == int(nxt["step"]) == i + 1
        assert int(got["opt"]["count"]) == int(nxt["opt"]["count"])
        lr = want["lr"]
        for (n, x), (_, p0), (_, y) in zip(named(got["params"]), named(prev["params"]),
                                          named(nxt["params"])):
            # each element's AdamW direction to 0.1 (a flipped sign is 2),
            # each leaf's update to 1e-3 of its norm
            np.testing.assert_allclose(x, y, rtol=0, atol=0.1 * lr, err_msg=f"{i} {n}")
            du, dw = x.astype(np.float64) - p0, y.astype(np.float64) - p0
            assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw), (i, n)
        for group in ("mu", "nu"):
            for (n, x), (_, y) in zip(named(got["opt"][group]), named(nxt["opt"][group])):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-4 * np.abs(y).max(),
                                           err_msg=f"{i} {group}{n}")
        free, fm = step(free, torch_batch(ref["batches"][i]))
        assert float(fm["loss"]) == pytest.approx(want["loss"], rel=1e-5), i


def test_grad_accumulation_equivalence(host_mesh):
    """microbatches=2 equals microbatches=1 (port of the reference's
    test, same tolerances), through ``make_train_step`` on
    ``make_host_mesh("cpu")`` as the reference's runs."""
    model = get_model(get_smoke_config("tinyllama-1.1b"))
    batch = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=8),
                            device="cpu").next()
    out = {}
    for k in (1, 2):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3), microbatches=k)
        fn, specs, _ = make_train_step(model, tcfg, host_mesh, batch)
        state = place(init_train_state(model, torch.Generator().manual_seed(1), tcfg, "cpu"),
                      host_mesh, specs)
        state, m = fn(state, batch)
        out[k] = (float(m["loss"]), tree_to_numpy(state["params"]))
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-5)
    for (n, a), (_, b) in zip(named(out[1][1]), named(out[2][1])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=n)


def test_loss_decreases():
    """The reference test's settings: 30 steps of tinyllama's smoke
    config, lr 1e-2 with 5 warmup steps."""
    model = get_model(get_smoke_config("tinyllama-1.1b"))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5, total_steps=60))
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=8), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
    step = build_train_step(model, tcfg)
    losses = []
    for _ in range(30):
        state, m = step(state, data.next())
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


# -- the pipeline ----------------------------------------------------------


def test_data_pipeline_deterministic_resume():
    cfg = DataConfig(vocab_size=1000, seq_len=40, global_batch=4, seed=9)
    d1 = SyntheticTokens(cfg, device="cpu")
    batches = [d1.next() for _ in range(5)]
    d2 = SyntheticTokens(cfg, device="cpu")
    d2.next(); d2.next()
    d3 = SyntheticTokens(cfg, state=d2.state_tree(), device="cpu")
    assert torch.equal(d3.next()["tokens"], batches[2]["tokens"])
    assert d3.state_tree()["batch_idx"].dtype == torch.int32
    assert int(d3.state_tree()["batch_idx"]) == 3
    # batch i is a function of (seed, i) alone
    assert torch.equal(SyntheticTokens(cfg, device="cpu").peek(4)["tokens"], batches[4]["tokens"])
    other = SyntheticTokens(DataConfig(vocab_size=1000, seq_len=40, global_batch=4, seed=10),
                            device="cpu")
    assert not torch.equal(other.peek(0)["tokens"], batches[0]["tokens"])


def test_data_pipeline_structure():
    """Runs base + step * pos (mod V), a noise token at pos % 17 == 0."""
    cfg = DataConfig(vocab_size=50, seq_len=60, global_batch=6, seed=3)
    toks = SyntheticTokens(cfg, device="cpu").peek(7)["tokens"].numpy()
    assert toks.dtype == np.int32 and toks.shape == (6, 60)
    assert toks.min() >= 0 and toks.max() < 50
    keep = np.arange(60) % 17 != 0
    steps = (toks[:, 2] - toks[:, 1]) % 50
    assert np.all((steps >= 1) & (steps < 7))
    want = (toks[:, 1:2] + steps[:, None] * (np.arange(60)[None, :] - 1)) % 50
    assert np.array_equal(toks[:, keep], want[:, keep])


# -- checkpoint round trips of the train state ----------------------------


def manager(root, **kw):
    return T.CheckpointManager(T.CheckpointConfig(
        root=str(root), cluster=T.theta_like(2, 2), strategy="stripe_aligned",
        device="cpu", **kw))


@pytest.fixture
def deterministic():
    """Bit-exact replay needs deterministic kernels: on the CPU the
    embedding gather's backward (an accumulating ``index_put_``) is
    otherwise threaded in no fixed order. ``run`` turns this on itself."""
    with deterministic_algorithms():
        yield


PRECODEC = {
    "host": {},
    "device_precodec": dict(codec="zstd+delta", chunk_size=8192, device_precodec=True),
}


@pytest.mark.parametrize("path", list(PRECODEC))
def test_train_ckpt_restore_bitexact(tmp_path, path, deterministic):
    """Save at step 4, continue to 6; restore 4 into a fresh state and
    replay 5 and 6: the same bits (port of the reference's test)."""
    model = get_model(get_smoke_config("tinyllama-1.1b"))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5, total_steps=60))
    data_cfg = DataConfig(vocab_size=256, seq_len=32, global_batch=8)
    step = build_train_step(model, tcfg)
    data = SyntheticTokens(data_cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
    mgr = manager(tmp_path, **PRECODEC[path])
    for i in range(4):
        state, _ = step(state, data.next())
        if i == 1:
            mgr.stage(2, {"train": state, "data": data.state_tree()})
            mgr.save(2, {"train": state, "data": data.state_tree()})
    full = {"train": state, "data": data.state_tree()}
    if mgr.stage(4, full):
        state, _ = step(state, data.next())   # in place, after stage()
        mgr.save(4, full)
    else:
        mgr.save(4, full)
        state, _ = step(state, data.next())
    state, _ = step(state, data.next())
    mgr.wait()
    mgr._l0 = None
    fresh = init_train_state(model, torch.Generator().manual_seed(5), tcfg, "cpu")
    d2 = SyntheticTokens(data_cfg, device="cpu")
    got, restored = mgr.restore({"train": fresh, "data": d2.state_tree()})
    assert got == 4
    copy_tree_(fresh, restored["train"])
    d2.load_state(restored["data"])
    for _ in range(2):
        fresh, _ = step(fresh, d2.next())
    assert_states_equal(fresh, state)
    assert int(d2.state_tree()["batch_idx"]) == int(data.state_tree()["batch_idx"]) == 6
    mgr.close()


def test_run_resumes_bit_exact(tmp_path):
    """The driver loop: steps 1-4 with a save every 2 (device pre-codec:
    the stage overlaps the next step), then a fresh run restores step 2
    and replays 3-4 to the same bits; step 4 restores equal too."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4))
    ckpt = T.CheckpointConfig(root=str(tmp_path), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192,
                              device_precodec=True, device="cpu")
    logs = []
    a = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=2, device="cpu", log=logs.append)
    assert [s.step for s in a.saves] == [2, 4] and not a.flush_errors
    assert all(s.flush is not None for s in a.saves)
    assert len(a.losses) == 4 and np.isfinite(a.losses).all()
    mgr = T.CheckpointManager(ckpt)
    _, at4 = mgr.restore({"train": a.state, "data": a.data.state_tree()}, step=4)
    mgr.close()
    assert_states_equal(at4["train"], a.state)
    b = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=0, resume=2, device="cpu",
            log=logs.append)
    assert b.restored_step == 2 and len(b.losses) == 2 and b.saves == []
    assert b.losses == a.losses[2:]
    assert_states_equal(b.state, a.state)
    assert int(b.data.state_tree()["batch_idx"]) == int(a.data.state_tree()["batch_idx"]) == 4
    assert "[resume] restored step 2 (train step 2)" in logs


def test_run_without_the_last_save(tmp_path):
    """``save_last=False``: steps 1-3 with a save every step save steps 1
    and 2 (each staged beside the next), not 3, and a resumed run replays
    step 3 from step 2."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=3))
    ckpt = T.CheckpointConfig(root=str(tmp_path), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192,
                              device_precodec=True, device="cpu")
    a = run(cfg, data_cfg, tcfg, ckpt, steps=3, ckpt_every=1, device="cpu", log=lambda _: None,
            save_last=False)
    assert [s.step for s in a.saves] == [1, 2] and not a.flush_errors
    mgr = T.CheckpointManager(ckpt)
    assert mgr.steps("pfs") == [1, 2]
    mgr.close()
    b = run(cfg, data_cfg, tcfg, ckpt, steps=3, ckpt_every=0, resume=True, device="cpu",
            log=lambda _: None)
    assert b.restored_step == 2 and b.losses == a.losses[2:]
    assert_states_equal(b.state, a.state)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("tinyllama-1.1b")
    model = get_model(cfg)
    data_cfg = DataConfig(vocab_size=256, seq_len=8, global_batch=2)
    for call in (lambda: model.init(torch.Generator()),
                 lambda: init_train_state(model, torch.Generator(), TrainConfig()),
                 lambda: SyntheticTokens(data_cfg),
                 lambda: run(cfg, data_cfg, TrainConfig(), None, steps=1, ckpt_every=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_train_and_resume(tmp_path):
    """Train 6 steps, then resume to 9 (port of the reference's test),
    on the 1x1 host mesh that ``main`` makes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
              "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "3",
              "--root", str(tmp_path), "--strategy", "stripe_aligned", "--codec", "zstd"]

    def cli(args):
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + args,
                              capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)

    first = cli(common + ["--steps", "6"])
    assert first.returncode == 0, first.stderr[-2000:]
    assert "step     6" in first.stdout and "[ckpt]" in first.stdout
    second = cli(common + ["--steps", "9", "--resume"])
    assert second.returncode == 0, second.stderr[-2000:]
    assert "[resume] restored step 6" in second.stdout
    assert "step     7" in second.stdout and "step     6" not in second.stdout
    assert "step     9" in second.stdout


# -- train states across the packages --------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b"] + MOE_VLM)
def test_reference_train_state_restores_into_port_and_continues(tmp_path, ref_steps, arch):
    """A reference state after two steps, saved by ``repro``, restores
    byte for byte into the port (the MoE state's nested ``moe`` leaves
    included); one more step in each package on the same batch agrees
    to float32 rounding."""
    ref = ref_steps[arch]
    state2 = ref["states"][2]
    saved = {"train": state2, "data": {"batch_idx": np.array(2, np.int32)}}
    mgr = R.CheckpointManager(R.CheckpointConfig(
        root=str(tmp_path), cluster=R.theta_like(2, 2), strategy="mpiio", codec="zstd"))
    mgr.save(2, saved)
    mgr.wait()
    mgr.close()

    model = get_model(get_smoke_config(arch))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    state = init_train_state(model, torch.Generator().manual_seed(9), tcfg, "cpu")
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=4,
                                      **data_kw(arch)), device="cpu")
    pm = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(3, 1), strategy="mpiio", codec="zstd",
        device="cpu"))
    step, restored = pm.restore({"train": state, "data": data.state_tree()})
    pm.close()
    assert step == 2
    copy_tree_(state, restored["train"])
    data.load_state(restored["data"])
    assert_bytes_equal(tree_to_numpy(state), state2)
    assert int(data.state_tree()["batch_idx"]) == 2

    state, m = build_train_step(model, tcfg)(state, torch_batch(ref["batches"][2]))
    assert float(m["loss"]) == pytest.approx(ref["metrics"][2]["loss"], rel=1e-5)
    for (n, x), (_, y) in zip(named(tree_to_numpy(state["params"])), named(ref["states"][3]["params"])):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b"] + MOE_VLM)
def test_port_train_state_restores_in_reference(tmp_path, arch):
    """A port state after two steps (bf16 compute), saved by the port
    with the device pre-codec, restores byte for byte in ``repro``."""
    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=4,
                                      **data_kw(arch)), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(2), tcfg, "cpu")
    step = build_train_step(model, tcfg)
    for _ in range(2):
        state, _ = step(state, data.next())
    full = {"train": state, "data": data.state_tree()}
    mgr = manager(tmp_path, **PRECODEC["device_precodec"])
    mgr.save(2, full)
    mgr.wait()
    mgr.close()

    ref_model = ref_get_model(ref_smoke_config(arch))
    target = {"train": to_np(ref_init_train_state(ref_model, jax.random.PRNGKey(0),
                                                  RefTrainConfig())),
              "data": {"batch_idx": np.array(0, np.int32)}}
    rm = R.CheckpointManager(R.CheckpointConfig(
        root=str(tmp_path), cluster=R.theta_like(3, 1), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=8192))
    got_step, restored = rm.restore(target)
    rm.close()
    assert got_step == 2
    assert_bytes_equal(to_np(restored), tree_to_numpy(full))
