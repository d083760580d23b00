"""The port's Whisper family held against the JAX reference on the CPU.

The same NumPy inputs and parameters go through ``repro.models.whisper``
(un-jitted, as the reference's own tests run it; the train steps through
``jax.jit(build_train_step)`` with no mesh) and
``repro_torch.models.whisper`` with ``device="cpu"``, at the smoke config
(``src/repro/configs/whisper_small.py::smoke_config``: 2 + 2 layers,
d_model 64, 4 heads of 16, enc_seq 12, float32): the new layers
(``layer_norm``, the sinusoidal tables, ``gelu_mlp``), the encoder, the
whole model (layout, loss, gradients, three AdamW steps, prefill with
every field of the ``WhisperCache`` and decode), the pipeline's frames,
serving (generate, snapshots within the port and across the packages),
train states across the packages and the launcher. Every test states its
tolerance; float32 cases are held to rounding (the packages sum in other
orders), the bf16-compute case to bf16 resolution.
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
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import get_model as ref_get_model
from repro.models import layers as ref_layers
from repro.models import whisper as ref_whisper
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import Server as RefServer
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import build_train_step as ref_build_train_step
from repro.train import init_train_state as ref_init_train_state
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.train import run
from repro_torch.models import get_model, layers, whisper
from repro_torch.serve import ServeConfig, Server
from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state
from repro_torch.utils.convert import (
    cache_from_numpy,
    cache_to_numpy,
    copy_tree_,
    train_state_from_numpy,
    tree_to_numpy,
)
from test_torch_xlstm import (
    ATOL,
    _decode_run,
    assert_bytes_equal,
    check_layout,
    check_published_layout,
    check_train_steps,
    close,
    named,
    port_model,
    port_names,
    ref_names,
    ref_params,
    rng,
    t,
    to_np,
    tokens,
)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-small"
CFG = get_smoke_config(ARCH)


def frames(seed, b):
    return rng(seed).standard_normal((b, CFG.enc_seq, CFG.d_model)).astype(np.float32)


def batch(seed, b, s):
    """Tokens and frames (NumPy) from ``seed``."""
    return {"tokens": tokens(seed, b, s), "frames": frames(seed + 100, b)}


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: t(v) for k, v in b.items()}


def data_config(**kw):
    return dict(vocab_size=CFG.vocab_size, seq_len=32, global_batch=4, enc_seq=CFG.enc_seq,
                d_model=CFG.d_model, family="audio", **kw)


# -- layers -------------------------------------------------------------------


def test_layer_norm_matches_reference():
    """Population variance, float32 inside, cast back: 1e-6 in float32;
    in bf16 within one bf16 rounding of the largest output."""
    r = rng(1)
    x = (3 + 2 * r.standard_normal((3, 7, 96))).astype(np.float32)
    s, b = (r.standard_normal(96).astype(np.float32) for _ in range(2))
    want = np.asarray(ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5))
    close(layers.layer_norm(t(x), t(s), t(b), 1e-5), want, 1e-6)
    want16 = ref_layers.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
                                   1e-5)
    got16 = layers.layer_norm(t(x).bfloat16(), t(s), t(b), 1e-5)
    assert got16.dtype == torch.bfloat16
    close(got16.float(), np.asarray(want16.astype(jnp.float32)), 2 ** -8 * np.abs(want).max())


def test_sinusoidal_tables_match_reference():
    """The NumPy table equals the reference's exactly; the analytic
    positions (float32 angles up to 1,499 radians) within 2e-4, the
    reference's own rounding of angles that large (a float32 ulp of
    1,499 is 1.2e-4)."""
    assert np.array_equal(layers.sinusoidal_positions(1500, 768),
                          ref_layers.sinusoidal_positions(1500, 768))
    pos = np.arange(1500)
    want = np.asarray(ref_layers.sinusoidal_positions_at(jnp.asarray(pos), 768))
    got = layers.sinusoidal_positions_at(t(pos), 768)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, 768)
    close(got, want, 2e-4)
    close(got[:64], want[:64], 1e-5)
    # a 0-d position with a leading axis, as decode_step passes it
    close(layers.sinusoidal_positions_at(torch.tensor([37], dtype=torch.int32), 64),
          np.asarray(ref_layers.sinusoidal_positions_at(jnp.asarray([37]), 64)), 1e-5)


def test_gelu_mlp_matches_reference():
    r = rng(3)
    x = r.standard_normal((2, 9, 96)).astype(np.float32)
    wi = (r.standard_normal((96, 192)) / 10).astype(np.float32)
    bi = r.standard_normal(192).astype(np.float32)
    wo = (r.standard_normal((192, 96)) / 14).astype(np.float32)
    bo = r.standard_normal(96).astype(np.float32)
    args = (x, wi, bi, wo, bo)
    want = np.asarray(ref_layers.gelu_mlp(*(jnp.asarray(a) for a in args)))
    close(layers.gelu_mlp(*(t(a) for a in args)), want, 1e-5)


# -- structure ----------------------------------------------------------------


def test_init_has_the_reference_layout():
    """Names, shapes and dtypes; ``enc_pos`` is a trainable parameter of
    the module (so AdamW updates it, as the reference's does), set to the
    sinusoidal table; the attentions have no ``bk``."""
    check_layout(ARCH)
    module = get_model(CFG).init(torch.Generator().manual_seed(0), "cpu")
    tree = module.state_tree()
    assert isinstance(tree["enc_pos"], torch.nn.Parameter) and tree["enc_pos"].requires_grad
    assert np.array_equal(tree["enc_pos"].detach().numpy(),
                          layers.sinusoidal_positions(CFG.enc_seq, CFG.d_model))
    assert sorted(tree["dec_layers"]["cross"]) == ["bo", "bq", "bv", "wk", "wo", "wq", "wv"]
    assert not tree["dec_layers"]["self"]["bq"].any() and bool(tree["enc_ln_s"].eq(1).all())
    from repro_torch.train import init_opt_state

    assert tuple(init_opt_state(tree, OptConfig())["mu"]["enc_pos"].shape) == \
        (CFG.enc_seq, CFG.d_model)


def test_param_count_at_published_widths():
    check_published_layout(ARCH, 239_435_520)


def test_init_is_a_function_of_the_generator():
    model = get_model(CFG)
    a, b, c = (tree_to_numpy(model.init(torch.Generator().manual_seed(s), "cpu").state_tree())
               for s in (3, 3, 4))
    fa, fb, fc = named(a), named(b), named(c)
    assert all(x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(fa, fb))
    assert any(x.tobytes() != y.tobytes() for (_, x), (_, y) in zip(fa, fc))
    wq = a["dec_layers"]["cross"]["wq"]
    assert wq.std() == pytest.approx(1 / np.sqrt(CFG.d_model), rel=0.05)


def test_batch_and_cache_structs_match_reference():
    """``batch_struct`` (tokens, frames in the compute dtype) and
    ``cache_struct`` (a ``WhisperCache`` whose cross K/V have enc_seq
    rows) have the reference's shapes and dtypes, on the meta device."""
    ref_model = ref_get_model(ref_smoke_config(ARCH).replace(compute_dtype="bfloat16"))
    model = get_model(CFG.replace(compute_dtype="bfloat16"))
    got, want = model.batch_struct(3, 20), ref_model.batch_struct(3, 20)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].device.type == "meta"
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    cs = model.cache_struct(3, 12)
    assert isinstance(cs, whisper.WhisperCache)
    assert port_names(cs) == ref_names(ref_model.cache_struct(3, 12))
    assert {x.device.type for _, x in named(cs)} == {"meta"}


# -- the model ----------------------------------------------------------------


def test_encode_matches_reference():
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=1)
    _, module = port_model(ARCH, ref_np)
    f = frames(1, 3)
    want = ref_whisper.encode(ref_p, ref_smoke_config(ARCH), jnp.asarray(f))
    with torch.no_grad():
        close(whisper.encode(module.state_tree(), CFG, t(f)), want)


def test_forward_and_loss_match_reference():
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=1)
    model, module = port_model(ARCH, ref_np)
    b = batch(6, 3, 40)
    want_logits, _ = ref_model.forward(ref_p, jb(b))
    want_loss, _ = ref_model.loss(ref_p, jb(b))
    with torch.no_grad():
        logits, aux = model.forward(module.state_tree(), tb(b))
        loss, parts = model.loss(module.state_tree(), tb(b))
        assert torch.equal(module(t(b["tokens"]), frames=t(b["frames"]))[0], logits)
    close(logits, want_logits)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(aux) == 0.0 and float(parts["ce"]) == float(loss)


def test_frames_change_the_logits():
    """The decoder reads the encoder's memory: other frames, other logits
    (a shift common to a frame's features would not do: LayerNorm takes
    it out)."""
    _, _, ref_np = ref_params(ARCH, seed=2)
    model, module = port_model(ARCH, ref_np)
    b = tb(batch(7, 2, 10))
    with torch.no_grad():
        a, _ = model.forward(module.state_tree(), b)
        c, _ = model.forward(module.state_tree(), {**b, "frames": t(frames(8, 2))})
    assert float((a - c).abs().max()) > 1e-3


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_reference(remat):
    """Every leaf's gradient (``enc_pos`` included) within 1e-4 of its
    largest element against ``jax.grad`` of the reference's loss, remat
    on and off on both sides."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=2)
    model, module = port_model(ARCH, ref_np)
    b = batch(7, 2, 32)
    want = jax.grad(lambda p: ref_model.loss(p, jb(b), remat=remat)[0])(ref_p)
    got_named = named(module.state_tree())
    loss, _ = model.loss(module.state_tree(), tb(b), remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in got_named])
    want_named = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in got_named] == [jax.tree_util.keystr(p) for p, _ in want_named]
    for (n, _), g, (_, w) in zip(got_named, grads, want_named):
        w = np.asarray(w)
        close(g, w, 1e-4 * np.abs(w).max(), n)
    assert float(grads[[n for n, _ in got_named].index("['enc_pos']")].abs().max()) > 0


def test_remat_changes_no_bit():
    """Recomputing each decoder block in backward gives the same loss and
    gradients, bit for bit (the encoder is recomputed either way)."""
    _, _, ref_np = ref_params(ARCH, seed=4)
    model, module = port_model(ARCH, ref_np)
    b = tb(batch(9, 2, 24))
    out = []
    for remat in (False, True):
        leaves = [p for _, p in named(module.state_tree())]
        loss, _ = model.loss(module.state_tree(), b, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_bf16_compute_matches_reference():
    """whisper-small's published numerics (float32 params, bf16 compute)
    at smoke widths: logits within 4 bf16 roundings of their largest, the
    loss to 1e-2 relative (as the dense model's bf16 case)."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=3, compute_dtype="bfloat16")
    model, module = port_model(ARCH, ref_np, compute_dtype="bfloat16")
    b = batch(8, 2, 32)
    want_logits, _ = ref_model.forward(ref_p, jb(b))
    want_loss, _ = ref_model.loss(ref_p, jb(b))
    with torch.no_grad():
        logits, _ = model.forward(module.state_tree(), tb(b))
        loss, _ = model.loss(module.state_tree(), tb(b))
    assert logits.dtype == torch.bfloat16
    want = np.asarray(want_logits.astype(jnp.float32))
    close(logits.float(), want, 4 * 2.0 ** -8 * np.abs(want).max())
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-2)


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted step (no mesh) from its init, three batches
    of its pipeline (tokens and frames), the states and metrics."""
    tcfg = RefTrainConfig(opt=RefOptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    model = ref_get_model(ref_smoke_config(ARCH))
    step = jax.jit(ref_build_train_step(model, tcfg))
    state = ref_init_train_state(model, jax.random.PRNGKey(0), tcfg)
    data = RefSyntheticTokens(RefDataConfig(**data_config()))
    states, metrics, batches = [to_np(state)], [], []
    for _ in range(3):
        batches.append(to_np(data.next()))
        state, m = step(state, batches[-1])
        states.append(to_np(state))
        metrics.append({k: float(v) for k, v in m.items()})
    assert sorted(batches[0]) == ["frames", "tokens"]
    return dict(states=states, metrics=metrics, batches=batches)


def test_train_steps_match_reference(ref_steps):
    """Three AdamW steps, each from the reference's state before it, held
    as ``tests/test_torch_xlstm.py::check_train_steps`` holds the other
    families (metrics rel 1e-5, parameters to 0.1 lr, moments to 1e-4)."""
    check_train_steps(ARCH, ref_steps)


def test_prefill_and_decode_match_reference():
    """Prefill, then 4 decode steps on the reference's greedy tokens:
    every step's logits and every field of the ``WhisperCache`` (the self
    K/V padded to s_max, the cross K/V ``xk``/``xv`` of the memory, pos)
    within 2e-5 by JAX's names; ``pos`` equal."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=3)
    model, module = port_model(ARCH, ref_np)
    params = module.state_tree()
    b, steps = batch(8, 2, 20), 4
    cache_r, lg_r = ref_model.prefill(ref_p, jb(b), s_max=20 + steps)
    with torch.no_grad():
        cache, lg = model.prefill(params, tb(b), s_max=20 + steps)
        assert isinstance(cache, whisper.WhisperCache)
        for step in range(steps + 1):
            close(lg, lg_r, ATOL, f"logits {step}")
            got, want = named(cache), jax.tree_util.tree_flatten_with_path(cache_r)[0]
            assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want] == \
                [".k", ".v", ".xk", ".xv", ".pos"]
            for (n, x), (_, y) in zip(got, want):
                assert str(x.dtype).replace("torch.", "") == str(y.dtype), n
                assert tuple(x.shape) == y.shape, n
                close(x, y, ATOL * max(1.0, float(np.abs(np.asarray(y)).max())), n)
            if step == steps:
                break
            tok = np.asarray(jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32))
            lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, jnp.asarray(tok))
            lg, cache = model.decode_step(params, cache, t(tok))


def test_init_cache_matches_reference():
    """``init_cache(params, b, s_max, memory)``: zero self K/V and the
    cross K/V of the memory, within 2e-5; on the params' device."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=5)
    model, module = port_model(ARCH, ref_np)
    f = frames(5, 3)
    mem_r = ref_whisper.encode(ref_p, ref_smoke_config(ARCH), jnp.asarray(f))
    want = ref_model.init_cache(ref_p, 3, 12, memory=mem_r)
    with torch.no_grad():
        mem = whisper.encode(module.state_tree(), CFG, t(f))
        got = model.init_cache(module.state_tree(), 3, 12, memory=mem)
    assert type(got) is whisper.WhisperCache
    for (n, x), (_, y) in zip(named(got), jax.tree_util.tree_flatten_with_path(want)[0]):
        close(x, y, ATOL, n)
    assert not got.k.any() and int(got.pos) == 0


def test_decode_leaves_its_cache_unchanged():
    _, _, ref_np = ref_params(ARCH)
    model, module = port_model(ARCH, ref_np)
    params = module.state_tree()
    with torch.no_grad():
        cache, lg = model.prefill(params, tb(batch(2, 2, 13)), s_max=16)
        before = tree_to_numpy(cache)
        _, nxt = model.decode_step(params, cache, lg.argmax(-1)[:, None].to(torch.int32))
    assert_bytes_equal(tree_to_numpy(cache), before)
    assert nxt.xk is cache.xk and nxt.xv is cache.xv      # static, shared


# -- the reference's model tests (tests/test_models.py:23-75) on the port ----


def test_smoke_forward_and_train_step():
    model = get_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    b = tb(batch(0, 2, 16))
    with torch.no_grad():
        logits, _ = model.forward(params, b)
    assert logits.shape == (2, 16, CFG.vocab_size)
    assert bool(torch.isfinite(logits).all())
    loss, _ = model.loss(params, b)
    assert np.isfinite(float(loss))
    gn = sum(float(g.abs().sum())
             for g in torch.autograd.grad(loss, [p for _, p in named(params)]))
    assert np.isfinite(gn) and gn > 0


def test_smoke_prefill_decode():
    model = get_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    with torch.no_grad():
        cache, logits = model.prefill(params, tb(batch(0, 2, 8)), s_max=12)
        assert logits.shape == (2, CFG.vocab_size)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits2, cache = model.decode_step(params, cache, tok)
    assert logits2.shape == (2, CFG.vocab_size)
    assert bool(torch.isfinite(logits2).all())


def test_decode_matches_teacher_forcing():
    """rtol/atol 2e-3, the reference's."""
    model = get_model(CFG)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    b = tb(batch(1, 2, 10))
    with torch.no_grad():
        full, _ = model.forward(params, b)
        cache, last = model.prefill(params, b, s_max=12)
        np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
        tok = last.argmax(-1)[:, None].to(torch.int32)
        lg2, _ = model.decode_step(params, cache, tok)
        full2, _ = model.forward(params, {**b, "tokens": torch.cat([b["tokens"], tok], 1)})
    np.testing.assert_allclose(lg2.numpy(), full2[:, -1].numpy(), rtol=2e-3, atol=2e-3)


# -- the pipeline's frames ----------------------------------------------------


def test_pipeline_draws_frames_and_replays_them():
    """float32 (global_batch, enc_seq, d_model) standard normal draws, a
    function of (seed, i): a pipeline restored at cursor 2 replays batch
    2's tokens and frames; another seed draws other frames."""
    dc = DataConfig(**data_config(seed=3))
    a = SyntheticTokens(dc, device="cpu")
    batches = [a.next() for _ in range(3)]
    f = batches[0]["frames"]
    assert sorted(batches[0]) == ["frames", "tokens"]
    assert f.dtype == torch.float32 and tuple(f.shape) == (4, CFG.enc_seq, CFG.d_model)
    assert abs(float(f.mean())) < 0.1 and abs(float(f.std()) - 1) < 0.1
    assert not torch.equal(batches[1]["frames"], f)
    again = SyntheticTokens(dc, device="cpu").next()
    assert all(torch.equal(again[k], batches[0][k]) for k in again)
    replay = SyntheticTokens(dc, state={"batch_idx": 2}, device="cpu").next()
    assert all(torch.equal(replay[k], batches[2][k]) for k in replay)
    other = SyntheticTokens(DataConfig(**data_config(seed=4)), device="cpu").next()
    assert not torch.equal(other["frames"], f)


# -- serving ------------------------------------------------------------------


def test_generate_matches_reference():
    """``Server.generate`` of NumPy tokens and frames: the reference
    server's greedy tokens exactly; the cache on the params' device."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=5)
    model, module = port_model(ARCH, ref_np)
    b = batch(10, 3, 12)
    want, _ = RefServer(ref_model, ref_p, RefServeConfig(max_new_tokens=6)).generate(jb(b))
    got, cache = Server(model, module.state_tree(), ServeConfig(max_new_tokens=6)).generate(b)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert isinstance(cache, whisper.WhisperCache) and int(cache.pos) == 12 + 6
    assert {x.device.type for _, x in named(cache)} == {"cpu"}


def _snapshot_manager(cls, root, cluster, **kw):
    return cls.CheckpointManager(cls.CheckpointConfig(
        root=str(root), cluster=cluster, strategy="stripe_aligned", codec="zstd+delta",
        chunk_size=8192, **kw))


def test_snapshot_resumes_with_the_same_tokens(tmp_path):
    """A serving snapshot (params, ``WhisperCache``, next token) saved with
    the device pre-codec and restored from the PFS (L1 dropped, another
    geometry) from meta templates into a fresh server: the restored cross
    K/V are the saved bytes (nothing re-encodes the frames) and the
    server emits the tokens the uninterrupted one would have."""
    _, _, ref_np = ref_params(ARCH, seed=6)
    model, module = port_model(ARCH, ref_np)
    server = Server(model, module.state_tree(), ServeConfig(max_new_tokens=8))
    b = batch(11, 2, 11)
    want, _ = server.generate(b)
    with torch.inference_mode():
        cache, logits = model.prefill(server.params, tb(b), s_max=19)
    first, cache, tok = _decode_run(model, server.params, cache,
                                    logits.argmax(-1)[:, None].to(torch.int32), 4)
    np.testing.assert_array_equal(first, want[:, :4])
    mgr = _snapshot_manager(T, tmp_path, T.theta_like(2, 2), device_precodec=True,
                            device="cpu")
    mgr.save(1, server.snapshot_state(cache) | {"tok": tok})
    mgr.wait()
    assert not mgr.flush_errors
    mgr.close()
    mgr = _snapshot_manager(T, tmp_path, T.theta_like(3, 1), device="cpu")
    for node in range(2):
        mgr.local.drop_node(node)
    _, got = mgr.restore({"params": model.param_struct(), "cache": model.cache_struct(2, 19),
                          "tok": torch.empty((2, 1), dtype=torch.int32, device="meta")})
    mgr.close()
    assert type(got["cache"]) is whisper.WhisperCache
    assert_bytes_equal(tree_to_numpy(got["cache"]), tree_to_numpy(cache))
    rest, _, _ = _decode_run(model, Server(model, got["params"]).params, got["cache"],
                             got["tok"], 4)
    np.testing.assert_array_equal(rest, want[:, 4:])


def test_jax_snapshot_continues_in_port():
    """A JAX serving state after prefill and three decode steps
    (``cache_from_numpy`` gives a ``WhisperCache``) continues in the port
    with the tokens the reference goes on to emit; ``cache_to_numpy``
    gives its bytes back."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=7)
    model, module = port_model(ARCH, ref_np)
    cache_r, lg_r = ref_model.prefill(ref_p, jb(batch(12, 2, 14)), s_max=24)
    out = []
    for i in range(8):
        tok = jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32)
        if i == 3:
            snap, snap_tok = to_np(cache_r), np.asarray(tok)
        out.append(np.asarray(tok)[:, 0])
        lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, tok)
    cache = cache_from_numpy(snap, "cpu")
    assert type(cache) is whisper.WhisperCache
    assert_bytes_equal(cache_to_numpy(cache), snap)
    got, _, _ = _decode_run(model, module.state_tree(), cache, t(snap_tok), 5)
    np.testing.assert_array_equal(got, np.stack(out[3:], 1))


def test_port_snapshot_continues_in_reference(tmp_path):
    """A port serving snapshot after prefill and three decode steps, saved
    by the port's manager with the device pre-codec, restores in
    ``repro`` under JAX's names (``['cache'].xk`` ...) byte for byte, and
    the reference decodes on from it with the port's tokens."""
    ref_model, ref_p, ref_np = ref_params(ARCH, seed=8)
    model, module = port_model(ARCH, ref_np)
    params = module.state_tree()
    with torch.inference_mode():
        cache, lg = model.prefill(params, tb(batch(13, 2, 9)), s_max=17)
    _, cache, tok = _decode_run(model, params, cache, lg.argmax(-1)[:, None].to(torch.int32), 3)
    want, _, _ = _decode_run(model, params, cache, tok, 5)
    mgr = _snapshot_manager(T, tmp_path, T.theta_like(2, 2), device_precodec=True,
                            device="cpu")
    mgr.save(1, {"params": params, "cache": cache, "tok": tok})
    mgr.wait()
    mgr.close()
    target = {"params": ref_np, "cache": to_np(ref_model.cache_struct(2, 17)),
              "tok": np.zeros((2, 1), np.int32)}
    target["cache"] = ref_whisper.WhisperCache(*(np.zeros(x.shape, x.dtype)
                                                 for x in target["cache"]))
    rm = _snapshot_manager(R, tmp_path, R.theta_like(3, 1))
    _, got = rm.restore(target)
    rm.close()
    assert type(got["cache"]).__name__ == "WhisperCache"
    assert_bytes_equal(to_np(got["cache"]), cache_to_numpy(cache))
    cache_r, tok_r, out = got["cache"], jnp.asarray(got["tok"]), []
    for _ in range(5):
        out.append(np.asarray(tok_r)[:, 0])
        lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, tok_r)
        tok_r = jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(np.stack(out, 1), want)


# -- train states across the packages, and the trainer ------------------------


def test_reference_train_state_restores_into_port(tmp_path, ref_steps):
    """The reference's state after two steps, saved by ``repro``, restores
    byte for byte into the port; one more step on the same batch (tokens
    and frames) agrees to float32 rounding."""
    state2 = ref_steps["states"][2]
    mgr = R.CheckpointManager(R.CheckpointConfig(
        root=str(tmp_path), cluster=R.theta_like(2, 2), strategy="mpiio", codec="zstd"))
    mgr.save(2, {"train": state2, "data": {"batch_idx": np.array(2, np.int32)}})
    mgr.wait()
    mgr.close()
    model = get_model(CFG)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    state = init_train_state(model, torch.Generator().manual_seed(9), tcfg, "cpu")
    data = SyntheticTokens(DataConfig(**data_config()), device="cpu")
    pm = T.CheckpointManager(T.CheckpointConfig(
        root=str(tmp_path), cluster=T.theta_like(3, 1), strategy="mpiio", codec="zstd",
        device="cpu"))
    step, restored = pm.restore({"train": state, "data": data.state_tree()})
    pm.close()
    assert step == 2
    copy_tree_(state, restored["train"])
    assert_bytes_equal(tree_to_numpy(state), state2)
    state, m = build_train_step(model, tcfg)(state, tb(ref_steps["batches"][2]))
    assert float(m["loss"]) == pytest.approx(ref_steps["metrics"][2]["loss"], rel=1e-5)
    for (n, x), (_, y) in zip(named(tree_to_numpy(state["params"])),
                              named(ref_steps["states"][3]["params"])):
        close(x, y, 1e-4, n)


def test_port_train_state_restores_in_reference(tmp_path):
    """A port state after two steps (bf16 compute), saved with the device
    pre-codec, restores byte for byte in ``repro`` (``enc_pos``'s moments
    included), and ``train_state_from_numpy`` loads it back."""
    model = get_model(CFG.replace(compute_dtype="bfloat16"))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2, total_steps=10))
    data = SyntheticTokens(DataConfig(**data_config()), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(2), tcfg, "cpu")
    step = build_train_step(model, tcfg)
    for _ in range(2):
        state, _ = step(state, data.next())
    assert float(state["opt"]["mu"]["enc_pos"].abs().max()) > 0
    full = {"train": state, "data": data.state_tree()}
    mgr = _snapshot_manager(T, tmp_path, T.theta_like(2, 2), device_precodec=True,
                            device="cpu")
    mgr.save(2, full)
    mgr.wait()
    mgr.close()
    ref_model = ref_get_model(ref_smoke_config(ARCH))
    target = {"train": to_np(ref_init_train_state(ref_model, jax.random.PRNGKey(0),
                                                  RefTrainConfig())),
              "data": {"batch_idx": np.array(0, np.int32)}}
    rm = _snapshot_manager(R, tmp_path, R.theta_like(3, 1))
    got_step, restored = rm.restore(target)
    rm.close()
    assert got_step == 2
    assert_bytes_equal(to_np(restored), tree_to_numpy(full))
    back = train_state_from_numpy(to_np(restored["train"]), model, "cpu")
    assert_bytes_equal(tree_to_numpy(back), tree_to_numpy(state))


def test_run_resumes_bit_exact(tmp_path):
    """The trainer's loop on tokens and frames: steps 1-4 saving 2 and 4
    with the device pre-codec; a fresh run restores step 2 and replays
    3-4 to the same bits."""
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, total_steps=4))
    ckpt = T.CheckpointConfig(root=str(tmp_path), cluster=T.theta_like(2, 2),
                              codec="zstd+delta", chunk_size=8192,
                              device_precodec=True, device="cpu")
    dc = DataConfig(**data_config())
    logs = []
    a = run(CFG, dc, tcfg, ckpt, steps=4, ckpt_every=2, device="cpu", log=logs.append)
    assert [s.step for s in a.saves] == [2, 4] and not a.flush_errors
    b = run(CFG, dc, tcfg, ckpt, steps=4, ckpt_every=0, resume=2, device="cpu",
            log=logs.append)
    assert b.restored_step == 2 and b.losses == a.losses[2:]
    assert_bytes_equal(tree_to_numpy(b.state), tree_to_numpy(a.state))
    assert "[resume] restored step 2 (train step 2)" in logs


def test_cli_train_and_resume(tmp_path):
    """``python -m repro_torch.launch.train --arch whisper-small --smoke
    --device cpu``: 3 steps with a checkpoint, then ``--resume`` to 6
    prints the same steps 4-6 as an uninterrupted 6-step run (the
    pipeline replays the frames too)."""
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
