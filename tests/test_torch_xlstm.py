"""The port's xLSTM family held against the JAX reference on the CPU.

The same NumPy inputs and parameters go through ``repro.models.xlstm``
(run un-jitted, as the reference's own tests run it; the train steps
through ``jax.jit(build_train_step)`` with no mesh) and
``repro_torch.models.xlstm`` with ``device="cpu"``, at the smoke config
(``src/repro/configs/xlstm_350m.py::smoke_config``, float32): module by
module (the conv helpers, the chunked and parallel mLSTM, the sLSTM time
loop and step, both decodes), then the whole model (layout, loss,
gradients, three AdamW steps, prefill and decode), serving (generate,
snapshots within the port and across the packages), train states across
the packages and the launcher. Every test states its tolerance. Float32
cases are held to rounding: the packages sum in other orders, and the
exponential gating (``exp`` of cumulative log gates) carries a rounding
of the log gates into every weight, so outputs of order 1 agree to a few
1e-6.

The whole-model checks are written once here, as ``check_*`` helpers,
and ``tests/test_torch_griffin.py`` runs them on recurrentgemma-2b.
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

import repro.core as R
import repro_torch.core as T
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import get_model as ref_get_model
from repro.models import xlstm as ref_xlstm
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import Server as RefServer
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import build_train_step as ref_build_train_step
from repro.train import init_train_state as ref_init_train_state
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.train import deterministic_algorithms, run
from repro_torch.models import get_model, xlstm
from repro_torch.serve import ServeConfig, Server
from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state
from repro_torch.utils.convert import (
    cache_from_numpy,
    cache_to_numpy,
    copy_tree_,
    params_from_numpy,
    train_state_from_numpy,
    tree_to_numpy,
)
from repro_torch.utils.treelib import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm-350m"
# float32 compute, outputs of order 1: rounding only (see the docstring)
ATOL = 2e-5


def rng(seed):
    return np.random.default_rng(seed)


def t(x):
    return torch.from_numpy(np.array(x))


def tokens(seed, b, s, v=256):
    return rng(seed).integers(0, v, (b, s)).astype(np.int32)


def named(tree):
    return flatten_with_names(tree)[0]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_params(arch, seed=0, **replace):
    cfg = ref_smoke_config(arch).replace(**replace)
    model = ref_get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, to_np(params)


def port_model(arch, params_np, **replace):
    model = get_model(get_smoke_config(arch).replace(**replace))
    return model, params_from_numpy(params_np, model, "cpu")


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, err_msg=msg)


def assert_bytes_equal(a, b):
    fa, fb = named(a), named(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n


def ref_names(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_names(tree):
    return [(n, tuple(x.shape), str(x.dtype).replace("torch.", "")) for n, x in named(tree)]


# -- whole-model checks, shared with tests/test_torch_griffin.py --------------


def check_layout(arch):
    """``state_tree()`` names (list entries as JAX's ``keystr`` spells
    them), shapes and dtypes equal the reference's init; its leaves are
    the module's own parameters; ``param_struct`` is the same tree on the
    meta device."""
    ref_model, _, ref_np = ref_params(arch)
    model = get_model(get_smoke_config(arch))
    module = model.init(torch.Generator().manual_seed(0), "cpu")
    assert port_names(module.state_tree()) == ref_names(ref_np)
    assert port_names(model.param_struct()) == ref_names(ref_np)
    assert {x.device.type for _, x in named(model.param_struct())} == {"meta"}
    assert model.param_count() == ref_model.param_count()
    assert {id(p) for p in module.parameters()} == {id(x) for _, x in named(module.state_tree())}


def check_published_layout(arch, count):
    """At published widths, on the meta device against ``eval_shape``:
    the same tree and exactly the reference's parameter count."""
    ref_model = ref_get_model(ref_get_config(arch))
    model = get_model(get_config(arch))
    assert port_names(model.param_struct()) == ref_names(ref_model.param_struct())
    assert model.param_count() == ref_model.param_count() == count


def check_forward_and_loss(arch, *, b=3, s=40, atol=ATOL):
    ref_model, ref_p, ref_np = ref_params(arch, seed=1)
    model, module = port_model(arch, ref_np)
    toks = tokens(6, b, s)
    want_logits, _ = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    want_loss, _ = ref_model.loss(ref_p, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux = model.forward(module.state_tree(), {"tokens": t(toks)})
        loss, parts = model.loss(module.state_tree(), {"tokens": t(toks)})
        assert torch.equal(module(t(toks))[0], logits)          # the nn.Module call
    close(logits, want_logits, atol)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(aux) == 0.0 and float(parts["ce"]) == float(loss)


def check_gradients(arch, remat, *, rel=1e-4):
    """Every leaf's gradient within ``rel`` of its largest element against
    ``jax.grad`` of the reference's loss (float32 rounding through
    backward), with remat on and off on both sides."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=2)
    model, module = port_model(arch, ref_np)
    toks = tokens(7, 2, 32)
    want = jax.grad(lambda p: ref_model.loss(p, {"tokens": jnp.asarray(toks)},
                                             remat=remat)[0])(ref_p)
    got_named = named(module.state_tree())
    loss, _ = model.loss(module.state_tree(), {"tokens": t(toks)}, remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in got_named])
    want_named = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in got_named] == [jax.tree_util.keystr(p) for p, _ in want_named]
    for (n, _), g, (_, w) in zip(got_named, grads, want_named):
        w = np.asarray(w)
        close(g, w, rel * np.abs(w).max(), n)


def check_remat_changes_no_bit(arch):
    """Recomputing each block in backward gives the same loss and
    gradients, bit for bit (the same ops run again on the CPU)."""
    _, _, ref_np = ref_params(arch, seed=4)
    model, module = port_model(arch, ref_np)
    toks = t(tokens(9, 2, 24))
    out = []
    for remat in (False, True):
        leaves = [p for _, p in named(module.state_tree())]
        loss, _ = model.loss(module.state_tree(), {"tokens": toks}, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def ref_train_steps(arch):
    """The reference's jitted step (no mesh), its initial state, three
    batches, the states it reaches and its metrics."""
    tcfg = RefTrainConfig(opt=RefOptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    model = ref_get_model(ref_smoke_config(arch))
    step = jax.jit(ref_build_train_step(model, tcfg))
    state = ref_init_train_state(model, jax.random.PRNGKey(0), tcfg)
    data = RefSyntheticTokens(RefDataConfig(vocab_size=256, seq_len=32, global_batch=4))
    states, metrics, batches = [to_np(state)], [], []
    for _ in range(3):
        batches.append(to_np(data.next()))
        state, m = step(state, batches[-1])
        states.append(to_np(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(states=states, metrics=metrics, batches=batches)


def check_train_steps(arch, ref):
    """Three AdamW steps, each from the reference's state before it, held
    as ``tests/test_torch_train.py::test_train_steps_match_reference``
    holds the dense ones (metrics rel 1e-5; each parameter's AdamW
    direction to 0.1 lr; mu and nu to 1e-4 of their largest element);
    the port's free-running losses rel 1e-5. Each leaf's update is held
    to 1e-3 of its norm over the elements whose gradient exceeds 100
    times AdamW's eps: AdamW divides each gradient element by its own
    magnitude, so an element whose gradient is near eps takes a step of
    up to lr in a direction set by its rounding (measured: one element
    of griffin's 4,096-element ``wq`` with a gradient of 5.8e-10 moved
    the leaf's update by 1.3e-3 of its norm)."""
    model = get_model(get_smoke_config(arch))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    beta1 = tcfg.opt.beta1
    step = build_train_step(model, tcfg)
    free = train_state_from_numpy(ref["states"][0], model, "cpu")
    for i in range(3):
        state = train_state_from_numpy(ref["states"][i], model, "cpu")
        batch = {k: t(v) for k, v in ref["batches"][i].items()}
        state, m = step(state, batch)
        want = ref["metrics"][i]
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(want[k], rel=1e-5), (i, k)
        got, prev, nxt = tree_to_numpy(state), ref["states"][i], ref["states"][i + 1]
        assert int(got["step"]) == int(nxt["step"]) == i + 1
        lr = want["lr"]
        for (n, x), (_, p0), (_, y), (_, mu0), (_, mu1) in zip(
                named(got["params"]), named(prev["params"]), named(nxt["params"]),
                named(prev["opt"]["mu"]), named(nxt["opt"]["mu"])):
            close(x, y, 0.1 * lr, f"{i} {n}")
            du, dw = x.astype(np.float64) - p0, y.astype(np.float64) - p0
            grad = (mu1.astype(np.float64) - beta1 * mu0) / (1 - beta1)   # the reference's
            live = np.abs(grad) > 100 * tcfg.opt.eps
            assert np.linalg.norm((du - dw)[live]) <= 1e-3 * np.linalg.norm(dw[live]), (i, n)
        for group in ("mu", "nu"):
            for (n, x), (_, y) in zip(named(got["opt"][group]), named(nxt["opt"][group])):
                close(x, y, 1e-4 * np.abs(y).max(), f"{i} {group}{n}")
        free, fm = step(free, batch)
        assert float(fm["loss"]) == pytest.approx(want["loss"], rel=1e-5), i


def check_prefill_and_decode(arch, *, b=2, s=20, steps=4, atol=ATOL):
    """Prefill, then decode steps on the reference's own greedy tokens:
    every step's logits and the whole state (every leaf, by JAX's names)
    within ``atol``; ``pos`` equal."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=3)
    model, module = port_model(arch, ref_np)
    params = module.state_tree()
    toks = tokens(8, b, s)
    cache_r, lg_r = ref_model.prefill(ref_p, {"tokens": jnp.asarray(toks)}, s_max=s + steps)
    with torch.no_grad():
        cache, lg = model.prefill(params, {"tokens": t(toks)}, s_max=s + steps)
        for step in range(steps + 1):
            close(lg, lg_r, atol, f"logits {step}")
            got, want = named(cache), jax.tree_util.tree_flatten_with_path(cache_r)[0]
            assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
            for (n, x), (_, y) in zip(got, want):
                assert str(x.dtype).replace("torch.", "") == str(y.dtype), n
                close(x.float(), y, atol * max(1.0, float(np.abs(np.asarray(y, np.float64))
                                                       .clip(max=1e6).max())), n)
            if step == steps:
                break
            tok = np.asarray(jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32))
            lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, jnp.asarray(tok))
            lg, cache = model.decode_step(params, cache, t(tok))


def check_cache_struct(arch):
    """``cache_struct`` and ``init_cache`` have the reference's tree,
    shapes and dtypes; the struct lives on the meta device, the cache on
    the params' device with the reference's initial values."""
    ref_model, ref_p, ref_np = ref_params(arch)
    model, module = port_model(arch, ref_np)
    want = ref_model.cache_struct(3, 12)
    assert port_names(model.cache_struct(3, 12)) == ref_names(want)
    assert {x.device.type for _, x in named(model.cache_struct(3, 12))} == {"meta"}
    cache = model.init_cache(module.state_tree(), 3, 12)
    assert_bytes_equal(tree_to_numpy(cache), to_np(ref_model.init_cache(ref_p, 3, 12)))


def check_smoke_forward_and_train_step(arch):
    """Port of ``tests/test_models.py::test_smoke_forward_and_train_step``."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    batch = {"tokens": t(tokens(0, 2, 16, cfg.vocab_size))}
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    loss, _ = model.loss(params, batch)
    assert np.isfinite(float(loss))
    leaves = [p for _, p in named(params)]
    gn = sum(float(g.abs().sum()) for g in torch.autograd.grad(loss, leaves))
    assert np.isfinite(gn) and gn > 0


def check_smoke_prefill_decode(arch):
    """Port of ``tests/test_models.py::test_smoke_prefill_decode``."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    with torch.no_grad():
        cache, logits = model.prefill(params, {"tokens": t(tokens(0, 2, 8, cfg.vocab_size))},
                                      s_max=12)
        assert logits.shape == (2, cfg.vocab_size)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits2, cache = model.decode_step(params, cache, tok)
    assert logits2.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all())


def check_decode_matches_teacher_forcing(arch):
    """Port of ``tests/test_models.py::test_decode_matches_teacher_forcing``
    (rtol/atol 2e-3, the reference's)."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    toks = t(tokens(1, 2, 10, cfg.vocab_size))
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        cache, last = model.prefill(params, {"tokens": toks}, s_max=12)
        np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
        tok = last.argmax(-1)[:, None].to(torch.int32)
        lg2, _ = model.decode_step(params, cache, tok)
        full2, _ = model.forward(params, {"tokens": torch.cat([toks, tok], dim=1)})
    np.testing.assert_allclose(lg2.numpy(), full2[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def check_decode_leaves_its_state_unchanged(arch):
    _, _, ref_np = ref_params(arch)
    model, module = port_model(arch, ref_np)
    params = module.state_tree()
    with torch.no_grad():
        cache, lg = model.prefill(params, {"tokens": t(tokens(2, 2, 13))}, s_max=16)
        before = tree_to_numpy(cache)
        model.decode_step(params, cache, lg.argmax(-1)[:, None].to(torch.int32))
    assert_bytes_equal(tree_to_numpy(cache), before)


def check_generate_matches_reference(arch):
    """``Server.generate`` on the CPU: the reference server's greedy
    tokens exactly, and the final state on the params' device."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=5)
    model, module = port_model(arch, ref_np)
    prompt = tokens(10, 3, 12)
    want, _ = RefServer(ref_model, ref_p, RefServeConfig(max_new_tokens=6)).generate(
        {"tokens": jnp.asarray(prompt)})
    got, cache = Server(model, module.state_tree(), ServeConfig(max_new_tokens=6)).generate(
        {"tokens": prompt})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert {x.device.type for _, x in named(cache)} == {"cpu"}
    assert int(cache["pos"]) == 12 + 6


def _decode_run(model, params, cache, tok, n):
    """n greedy decode steps from (cache, tok): (emitted tokens (B, n),
    cache, next token)."""
    out = []
    with torch.inference_mode():
        for _ in range(n):
            out.append(tok[:, 0].numpy())
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
    return np.stack(out, 1), cache, tok


def check_snapshot_resume(arch, tmp_path):
    """A serving snapshot (params, recurrent state, next token) saved
    through ``CheckpointManager(device="cpu")`` and restored from the PFS
    (L1 dropped, another geometry) into a fresh server, from templates
    on the meta device (``param_struct``, ``cache_struct``), emits the
    tokens the uninterrupted server would have."""
    _, _, ref_np = ref_params(arch, seed=6)
    model, module = port_model(arch, ref_np)
    server = Server(model, module.state_tree(), ServeConfig(max_new_tokens=8))
    prompt = tokens(11, 2, 11)
    want, _ = server.generate({"tokens": prompt})
    with torch.inference_mode():
        cache, logits = model.prefill(server.params, {"tokens": t(prompt)})
    first, cache, tok = _decode_run(model, server.params, cache,
                                    logits.argmax(-1)[:, None].to(torch.int32), 4)
    np.testing.assert_array_equal(first, want[:, :4])
    mgr = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(2, 2), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=8192, device_precodec=True, device="cpu"))
    mgr.save(1, server.snapshot_state(cache) | {"tok": tok})
    mgr.wait()
    assert not mgr.flush_errors
    mgr.close()
    mgr = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(3, 1), strategy="stripe_aligned",
        codec="zstd+delta", device="cpu"))
    for node in range(2):
        mgr.local.drop_node(node)
    _, got = mgr.restore({"params": model.param_struct(), "cache": model.cache_struct(2, 0),
                          "tok": torch.empty((2, 1), dtype=torch.int32, device="meta")})
    mgr.close()
    assert_bytes_equal(tree_to_numpy(got["cache"]), tree_to_numpy(cache))
    fresh = Server(model, got["params"], server.cfg)
    rest, _, _ = _decode_run(model, fresh.params, got["cache"], got["tok"], 4)
    np.testing.assert_array_equal(rest, want[:, 4:])


def check_jax_snapshot_continues_in_port(arch):
    """A JAX serving state after prefill and three decode steps
    (``cache_from_numpy``) continues in the port with the tokens the
    reference goes on to emit; ``cache_to_numpy`` gives its bytes back."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=7)
    model, module = port_model(arch, ref_np)
    cache_r, lg_r = ref_model.prefill(ref_p, {"tokens": jnp.asarray(tokens(12, 2, 14))}, s_max=24)
    out = []
    for i in range(8):
        tok = jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32)
        if i == 3:
            snap, snap_tok = to_np(cache_r), np.asarray(tok)
        out.append(np.asarray(tok)[:, 0])
        lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, tok)
    cache = cache_from_numpy(snap, "cpu")
    assert_bytes_equal(cache_to_numpy(cache), snap)
    got, _, _ = _decode_run(model, module.state_tree(), cache, t(snap_tok), 5)
    np.testing.assert_array_equal(got, np.stack(out[3:], 1))


def check_reference_train_state_restores_into_port(arch, tmp_path):
    """A reference state after two steps, saved by ``repro``, restores
    byte for byte into the port (``param_struct`` shaped), and one more
    step in each package on the same batch agrees to float32 rounding."""
    ref = ref_train_steps(arch)
    state2 = ref["states"][2]
    mgr = R.CheckpointManager(R.CheckpointConfig(
        root=str(tmp_path), cluster=R.theta_like(2, 2), strategy="mpiio", codec="zstd"))
    mgr.save(2, {"train": state2, "data": {"batch_idx": np.array(2, np.int32)}})
    mgr.wait()
    mgr.close()
    model = get_model(get_smoke_config(arch))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    state = init_train_state(model, torch.Generator().manual_seed(9), tcfg, "cpu")
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=4), device="cpu")
    pm = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(3, 1), strategy="mpiio", codec="zstd",
        device="cpu"))
    step, restored = pm.restore({"train": state, "data": data.state_tree()})
    pm.close()
    assert step == 2
    copy_tree_(state, restored["train"])
    assert_bytes_equal(tree_to_numpy(state), state2)
    state, m = build_train_step(model, tcfg)(state, {k: t(v) for k, v in ref["batches"][2].items()})
    assert float(m["loss"]) == pytest.approx(ref["metrics"][2]["loss"], rel=1e-5)
    for (n, x), (_, y) in zip(named(tree_to_numpy(state["params"])),
                              named(ref["states"][3]["params"])):
        close(x, y, 1e-4, n)


def check_port_train_state_restores_in_reference(arch, tmp_path):
    """A port state after two steps (bf16 compute), saved by the port
    with the device pre-codec, restores byte for byte in ``repro``."""
    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    data = SyntheticTokens(DataConfig(vocab_size=256, seq_len=32, global_batch=4), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(2), tcfg, "cpu")
    step = build_train_step(model, tcfg)
    for _ in range(2):
        state, _ = step(state, data.next())
    full = {"train": state, "data": data.state_tree()}
    mgr = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(2, 2), strategy="stripe_aligned",
        codec="zstd+delta", chunk_size=8192, device_precodec=True, device="cpu"))
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


def check_run_resumes_bit_exact(arch, tmp_path):
    """The trainer's loop: steps 1-4 saving 2 and 4 with the device
    pre-codec, then a fresh run restores step 2 and replays 3-4 to the
    same bits."""
    cfg = get_smoke_config(arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4))
    ckpt = T.CheckpointConfig(root=str(tmp_path), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192,
                              device_precodec=True, device="cpu")
    logs = []
    a = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=2, device="cpu", log=logs.append)
    assert [s.step for s in a.saves] == [2, 4] and not a.flush_errors
    b = run(cfg, data_cfg, tcfg, ckpt, steps=4, ckpt_every=0, resume=2, device="cpu",
            log=logs.append)
    assert b.restored_step == 2 and b.losses == a.losses[2:]
    assert_bytes_equal(tree_to_numpy(b.state), tree_to_numpy(a.state))
    assert "[resume] restored step 2 (train step 2)" in logs


# -- module by module ---------------------------------------------------------


def test_conv_helpers_match_reference():
    """``_conv_causal`` over a sequence and ``_conv_step`` on a state:
    float32 products and sums of four terms, 1e-6."""
    r = rng(1)
    x = r.standard_normal((2, 13, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32) * 0.3
    b = r.standard_normal(24).astype(np.float32)
    want = ref_xlstm._conv_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    close(xlstm._conv_causal(t(x), t(w), t(b)), want, 1e-6)
    state = r.standard_normal((2, 3, 24)).astype(np.float32)
    want_out, want_state = ref_xlstm._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                               jnp.asarray(w), jnp.asarray(b))
    out, new_state = xlstm._conv_step(t(x[:, 0]), t(state), t(w), t(b))
    close(out, want_out, 1e-6)
    assert np.array_equal(new_state.numpy(), np.asarray(want_state))


def _mlstm_inputs(seed, b=2, s=64, h=4, hd=8):
    r = rng(seed)
    q, k, v = (r.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    logf = np.log(1 / (1 + np.exp(-(r.standard_normal((b, s, h)) + 3.0)))).astype(np.float32)
    logi = r.standard_normal((b, s, h)).astype(np.float32)
    return q, k, v, logf, logi


def test_mlstm_chunked_matches_reference():
    """s = 64 in chunks of 16 (three carries cross a boundary): h and the
    final (C, n, m) within 2e-5 of outputs of order 1 (C, n to 2e-5 of
    their largest element; m exactly a max of sums, 1e-5)."""
    q, k, v, logf, logi = _mlstm_inputs(2)
    want_h, (want_c, want_n, want_m) = ref_xlstm._mlstm_chunked(
        *(jnp.asarray(a) for a in (q, k, v, logf, logi)), 16)
    got_h, (c, n, m) = xlstm._mlstm_chunked(*(t(a) for a in (q, k, v, logf, logi)), 16)
    close(got_h, want_h)
    for got, want in ((c, want_c), (n, want_n)):
        close(got, want, 2e-5 * np.abs(np.asarray(want)).max())
    close(m, want_m, 1e-5)


def test_mlstm_parallel_matches_chunked():
    """Within the port: the quadratic form over the whole sequence
    equals the chunked form (the carry is exact), and the reference's
    parallel form, to float32 rounding: 5e-6 of the largest output (the
    outputs reach 20 here, where a few late rows' denominators are
    small)."""
    q, k, v, logf, logi = _mlstm_inputs(3)
    par = xlstm._mlstm_parallel(*(t(a) for a in (q, k, v, logf, logi)))
    chunked, _ = xlstm._mlstm_chunked(*(t(a) for a in (q, k, v, logf, logi)), 16)
    want = np.asarray(ref_xlstm._mlstm_parallel(*(jnp.asarray(a) for a in (q, k, v, logf, logi))))
    tol = 5e-6 * np.abs(want).max()
    close(par, chunked, tol)
    close(par, want, tol)


def _slstm_params(seed):
    cfg = get_smoke_config(ARCH)
    p = xlstm.init_slstm(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, ref_smoke_config(ARCH), {k: v.detach().numpy().copy() for k, v in p.items()}


def test_slstm_block_and_step_match_reference():
    """The sLSTM block (the time loop over 48 positions) and one
    ``_slstm_step`` from a random carry: 2e-5."""
    cfg, rcfg, p = _slstm_params(4)
    r = rng(4)
    x = r.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    close(xlstm.slstm_block(tp, cfg, t(x)).detach(), ref_xlstm.slstm_block(jp, rcfg, jnp.asarray(x)))
    hd = cfg.d_model // cfg.n_heads
    carry = [r.standard_normal((2, cfg.n_heads, hd)).astype(np.float32) for _ in range(4)]
    carry[2] = np.abs(carry[2]) + 0.5                              # n > 0
    wx = r.standard_normal((2, 4 * cfg.d_model)).astype(np.float32)
    want, want_y = ref_xlstm._slstm_step(jp, rcfg, tuple(map(jnp.asarray, carry)), jnp.asarray(wx))
    got, y = xlstm._slstm_step(tp, cfg, tuple(map(t, carry)), t(wx))
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    close(y, want_y, 1e-5)


def _plain_scan(pre_x, r, carry):
    """The sLSTM's time loop recorded op by op by autograd: the
    reference the written-out backward is held to."""
    hs = []
    for px in pre_x.unbind(0):
        carry, _ = xlstm._slstm_cell(r, carry, px)
        hs.append(carry[0])
    return (torch.stack(hs), *carry)


def test_slstm_scan_backward_matches_autograd_of_the_loop():
    """``_SLSTMScan`` (the loop with its backward written out) against
    autograd through the same loop, in float64 over 40 steps, with
    gradients arriving at every output and at the final carry: the
    forward bit for bit, d pre_x and d r to 1e-12 of their largest
    element; and ``gradcheck`` on a short loop."""
    r_ = rng(8)
    s, h, b, hd = 40, 4, 3, 16
    pre_x = torch.from_numpy(2 * r_.standard_normal((s, h, b, 4 * hd)))
    r = torch.from_numpy(0.3 * r_.standard_normal((h, hd, 4 * hd)))
    carry = (torch.zeros(h, b, hd, dtype=torch.float64), torch.zeros(h, b, hd, dtype=torch.float64),
             torch.full((h, b, hd), 1e-6, dtype=torch.float64),
             torch.full((h, b, hd), -1e30, dtype=torch.float64))
    weights = [torch.from_numpy(r_.standard_normal(shape))
               for shape in ((s, h, b, hd),) + ((h, b, hd),) * 4]
    out = {}
    for name, fn in (("plain", _plain_scan), ("written", xlstm._SLSTMScan.apply)):
        px, rr = pre_x.clone().requires_grad_(), r.clone().requires_grad_()
        ys = fn(px, rr, *carry) if name == "written" else fn(px, rr, carry)
        loss = sum((y * w).sum() for y, w in zip(ys, weights) if bool(torch.isfinite(y).all()))
        out[name] = (ys[0].detach(), torch.autograd.grad(loss, [px, rr]))
    assert torch.equal(out["plain"][0], out["written"][0])
    for got, want in zip(out["written"][1], out["plain"][1]):
        close(got, want, 1e-12 * float(want.abs().max()))
    px = torch.from_numpy(r_.standard_normal((5, 2, 1, 16))).requires_grad_()
    rr = torch.from_numpy(0.3 * r_.standard_normal((2, 4, 16))).requires_grad_()
    small = tuple(x[:2, :1, :4] for x in carry)
    assert torch.autograd.gradcheck(lambda a, b: xlstm._SLSTMScan.apply(a, b, *small)[0], (px, rr))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_reference_from_a_random_state(kind):
    """``mlstm_decode`` / ``slstm_decode`` from a random state (the
    stabiliser m of order 1, n positive): output and new state, 2e-5
    relative to each leaf's largest element."""
    cfg, rcfg = get_smoke_config(ARCH), ref_smoke_config(ARCH)
    init = xlstm.init_mlstm if kind == "mlstm" else xlstm.init_slstm
    p = {k: v.detach().numpy().copy() for k, v in
         init(cfg, torch.Generator().manual_seed(5), "cpu").items()}
    r = rng(5)
    shapes = {k: tuple(v.shape) for k, v in
              (xlstm.mlstm_state if kind == "mlstm" else xlstm.slstm_state)(cfg, 3).items()}
    state = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    state["n"] = np.abs(state["n"]) + 0.5
    x = r.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    fn = {"mlstm": (ref_xlstm.mlstm_decode, xlstm.mlstm_decode),
          "slstm": (ref_xlstm.slstm_decode, xlstm.slstm_decode)}[kind]
    want_st, want_y = fn[0]({k: jnp.asarray(v) for k, v in p.items()}, rcfg,
                            {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x))
    got_st, y = fn[1]({k: t(v) for k, v in p.items()}, cfg,
                      {k: t(v) for k, v in state.items()}, t(x))
    close(y.detach(), want_y, 2e-5 * np.abs(np.asarray(want_y)).max())
    assert sorted(got_st) == sorted(want_st)
    for k in want_st:
        w = np.asarray(want_st[k])
        close(got_st[k].detach(), w, 2e-5 * max(1.0, np.abs(w).max()), k)


# -- the whole model ----------------------------------------------------------


def test_init_has_the_reference_layout():
    check_layout(ARCH)


def test_param_count_at_published_widths():
    check_published_layout(ARCH, 481_082_512)


def test_forward_and_loss_match_reference():
    check_forward_and_loss(ARCH)


def test_forward_crosses_an_mlstm_chunk_boundary():
    """s = 2048 over two chunks of 1024, at smoke widths (one mLSTM
    block): the carried state enters the second chunk. 2e-5."""
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    p = {k: v.detach().numpy().copy() for k, v in
         xlstm.init_mlstm(cfg, torch.Generator().manual_seed(6), "cpu").items()}
    x = rng(6).standard_normal((1, 2048, cfg.d_model)).astype(np.float32)
    want = ref_xlstm.mlstm_block({k: jnp.asarray(v) for k, v in p.items()}, rcfg, jnp.asarray(x))
    with torch.no_grad():
        got = xlstm.mlstm_block({k: t(v) for k, v in p.items()}, cfg, t(x))
    close(got, want)


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_reference(remat):
    check_gradients(ARCH, remat)


def test_remat_changes_no_bit():
    check_remat_changes_no_bit(ARCH)


@pytest.fixture(scope="module")
def ref_steps():
    return ref_train_steps(ARCH)


def test_train_steps_match_reference(ref_steps):
    check_train_steps(ARCH, ref_steps)


def test_smoke_forward_and_train_step():
    check_smoke_forward_and_train_step(ARCH)


def test_smoke_prefill_decode():
    check_smoke_prefill_decode(ARCH)


def test_decode_matches_teacher_forcing():
    check_decode_matches_teacher_forcing(ARCH)


def test_prefill_and_decode_match_reference():
    check_prefill_and_decode(ARCH)


def test_decode_leaves_its_state_unchanged():
    check_decode_leaves_its_state_unchanged(ARCH)


def test_cache_struct_and_init_cache():
    check_cache_struct(ARCH)


# -- serving ------------------------------------------------------------------


def test_generate_matches_reference():
    check_generate_matches_reference(ARCH)


def test_snapshot_resumes_with_the_same_tokens(tmp_path):
    check_snapshot_resume(ARCH, tmp_path)


def test_jax_snapshot_continues_in_port():
    check_jax_snapshot_continues_in_port(ARCH)


def test_generate_refuses_a_state_on_another_device():
    """The cache guard of ``Server.generate`` reads every tensor leaf of
    a recurrent state, not a transformer cache's ``k``."""
    _, _, ref_np = ref_params(ARCH)
    model, module = port_model(ARCH, ref_np)

    class Elsewhere:
        cfg = model.cfg

        def prefill(self, params, batch, s_max=None):
            cache, logits = model.prefill(params, batch, s_max=s_max)
            cache["layers"][-1]["m"] = torch.empty(cache["layers"][-1]["m"].shape, device="meta")
            return cache, logits

    server = Server(Elsewhere(), module.state_tree(), ServeConfig(max_new_tokens=2))
    with pytest.raises(RuntimeError, match="meta"):
        server.generate({"tokens": tokens(0, 1, 5)})


# -- train states across the packages, and the launcher -----------------------


def test_reference_train_state_restores_into_port(tmp_path):
    check_reference_train_state_restores_into_port(ARCH, tmp_path)


def test_port_train_state_restores_in_reference(tmp_path):
    check_port_train_state_restores_in_reference(ARCH, tmp_path)


def test_run_resumes_bit_exact(tmp_path):
    check_run_resumes_bit_exact(ARCH, tmp_path)


def test_cli_train_and_resume(tmp_path):
    """``python -m repro_torch.launch.train --arch xlstm-350m --smoke``:
    3 steps with a checkpoint, then ``--resume`` to 6 prints the same
    steps 4-6 as an uninterrupted 6-step run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--global-batch", "4",
              "--seq-len", "32", "--strategy", "stripe_aligned", "--codec", "zstd",
              "--lr", "1e-2"]

    def cli(root, args):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common,
                            "--root", str(root), *args],
                           capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        return [line for line in r.stdout.splitlines() if line.startswith("step")], r.stdout

    whole, _ = cli(tmp_path / "whole", ["--steps", "6", "--ckpt-every", "0"])
    first, out1 = cli(tmp_path / "split", ["--steps", "3", "--ckpt-every", "3"])
    second, out2 = cli(tmp_path / "split", ["--steps", "6", "--ckpt-every", "3", "--resume"])
    assert "[ckpt]" in out1 and "[resume] restored step 3" in out2

    def losses(lines):
        return [line.split("step_time")[0] for line in lines]

    assert losses(first + second) == losses(whole)
    assert len(whole) == 6


def test_slstm_at_published_widths_is_chaotic_and_overflows_as_the_reference():
    """Faults of the reference that the port shares, not divergences. At
    xlstm-350m's widths the sLSTM's recurrent kernel (std 0.4 over a
    fan-in of 256, ``repro/models/xlstm.py:281``) makes the time loop
    chaotic: a rounding difference grows about twice a token, so the two
    packages' outputs agree to 1e-4 over the first 8 tokens (3.5e-5 at
    token 8, measured) and by token 40 differ by order 1, as the port's
    own output does for an input moved by one ulp. Its backward grows
    with the sequence: over 64 tokens every gradient is finite in both,
    over 1,024 both overflow float32 in the same leaves (those before the
    loop's output: ``b``, ``ln``, ``r``, ``w``)."""
    cfg = get_config(ARCH).replace(compute_dtype="float32")
    rcfg = ref_get_config(ARCH).replace(compute_dtype="float32")
    p = {k: v.detach().numpy().copy() for k, v in
         xlstm.init_slstm(cfg, torch.Generator().manual_seed(0), "cpu").items()}

    def loss(pp, xx):
        return jnp.mean(jnp.square(ref_xlstm.slstm_block(pp, rcfg, xx)))

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    fwd = jax.jit(lambda pp, xx: ref_xlstm.slstm_block(pp, rcfg, xx))
    for s in (64, 1024):
        x = rng(s).standard_normal((1, s, cfg.d_model)).astype(np.float32)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        _, want = value_and_grad(jp, jnp.asarray(x))
        tp = {k: t(v).requires_grad_() for k, v in p.items()}
        y = xlstm.slstm_block(tp, cfg, t(x))
        got = dict(zip(tp, torch.autograd.grad(y.square().mean(), list(tp.values()))))
        finite = {k for k, g in got.items() if bool(torch.isfinite(g).all())}
        assert finite == {k for k, w in want.items() if bool(jnp.isfinite(w).all())}, s
        assert finite == (set(p) if s == 64 else {"gn", "w_down"}), s
        if s == 64:
            ref_y = np.asarray(fwd(jp, jnp.asarray(x)))
            close(y[:, :8].detach(), ref_y[:, :8], 1e-4)
            with torch.no_grad():
                moved = xlstm.slstm_block(tp, cfg, t(np.nextafter(x, np.inf)))
            for other in (t(ref_y), moved):
                assert float((y - other)[:, 40:].abs().max()) > 0.1
