"""The port's VLM path (patch embeddings ahead of the text) held against
the JAX reference on the CPU, and the pipeline's patches.

llava-next-mistral-7b's smoke config (float32) goes through
``repro.models`` (un-jitted) and ``repro_torch.models`` on the same
NumPy parameters, tokens and patches; each test states its tolerance.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import get_model as ref_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import get_model
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.treelib import flatten_with_names

ARCH = "llava-next-mistral-7b"


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def models():
    """The reference model and params (seed 1), and the port's on the
    same NumPy params."""
    ref_model = ref_get_model(ref_smoke_config(ARCH))
    ref_p = ref_model.init(jax.random.PRNGKey(1))
    ref_np = jax.tree_util.tree_map(np.asarray, ref_p)
    model = get_model(get_smoke_config(ARCH))
    return ref_model, ref_p, model, params_from_numpy(ref_np, model, "cpu")


def batch(seed, b, s):
    cfg = get_smoke_config(ARCH)
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patches": r.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def test_init_has_the_reference_layout(models):
    ref_model, ref_p, model, module = models
    got = [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for n, x in flatten_with_names(module.state_tree())[0]]
    want = [(jax.tree_util.keystr(p), x.shape, str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(ref_p)[0]]
    assert got == want
    assert model.param_count() == ref_model.param_count()


def test_published_layout_and_param_count():
    """At published widths (meta device against ``jax.eval_shape``):
    bfloat16 params, the reference's count exactly; a 2-layer cut is
    698,372,096 parameters (a 4.19 GB bf16 train state)."""
    ref_model = ref_get_model(ref_get_config(ARCH))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(ref_model.param_struct())[0]]
    module = Transformer(get_config(ARCH), device="meta")
    got = [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for n, x in flatten_with_names(module.state_tree())[0]]
    assert got == want
    assert get_model(get_config(ARCH)).param_count() == ref_model.param_count() == 7_241_732_096
    assert get_model(get_config(ARCH).replace(n_layers=2)).param_count() == 698_372_096


def test_batch_struct_matches_reference():
    """Patches fill the front of the sequence; the text fills the rest
    (at least one token)."""
    for seq_len in (2048, 100):
        want = ref_get_model(ref_get_config(ARCH)).batch_struct(4, seq_len)
        got = get_model(get_config(ARCH)).batch_struct(4, seq_len)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (seq_len, k)
            assert str(got[k].dtype) == "torch." + str(want[k].dtype), (seq_len, k)
            assert got[k].device.type == "meta"
    assert tuple(get_model(get_config(ARCH)).batch_struct(4, 2048)["tokens"].shape) == (4, 1472)


def test_forward_and_loss_match_reference(models):
    """Logits over patches and text within 1e-5; the loss (text
    positions only) within 1e-5 relative (float32 compute)."""
    ref_model, ref_p, model, module = models
    b = batch(2, 3, 20)
    want_logits, _ = ref_model.forward(ref_p, jax.tree_util.tree_map(jnp.asarray, b))
    want_loss, _ = ref_model.loss(ref_p, jax.tree_util.tree_map(jnp.asarray, b))
    with torch.no_grad():
        logits, aux = model.forward(module.state_tree(), {k: t(v) for k, v in b.items()})
        loss, parts = model.loss(module.state_tree(), {k: t(v) for k, v in b.items()})
    assert logits.shape == (3, 20 + model.cfg.n_patches, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(aux) == 0.0 and float(parts["ce"]) == float(loss)


def test_loss_predicts_text_from_the_prefix_end(models):
    """The loss reads the logits of positions n_patches .. n_patches +
    T - 2: it equals the cross-entropy of those rows against tokens 1..T-1."""
    _, _, model, module = models
    b = {k: t(v) for k, v in batch(3, 2, 12).items()}
    with torch.no_grad():
        logits, _ = model.forward(module.state_tree(), b)
        loss, _ = model.loss(module.state_tree(), b)
    n = model.cfg.n_patches
    want = torch.nn.functional.cross_entropy(
        logits[:, n : n + 11].reshape(-1, logits.shape[-1]).float(),
        b["tokens"][:, 1:].reshape(-1).long())
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_gradients_match_reference(models):
    """Every leaf's gradient within 1e-4 of its largest element."""
    ref_model, ref_p, model, module = models
    b = batch(4, 2, 16)
    want = jax.grad(lambda p: ref_model.loss(p, jax.tree_util.tree_map(jnp.asarray, b))[0])(ref_p)
    named = flatten_with_names(module.state_tree())[0]
    loss, _ = model.loss(module.state_tree(), {k: t(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, [p for _, p in named])
    for (n, _), g, w in zip(named, grads, jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=n)


def test_prefill_and_decode_match_reference(models):
    """Prefill over patches and text (the cache's position is
    n_patches + S), then three decode steps on the reference's greedy
    tokens: logits and caches within 1e-5."""
    ref_model, ref_p, model, module = models
    params = module.state_tree()
    b = batch(5, 2, 10)
    n = model.cfg.n_patches
    cache_r, lg_r = ref_model.prefill(ref_p, jax.tree_util.tree_map(jnp.asarray, b),
                                      s_max=n + 14)
    with torch.no_grad():
        cache, lg = model.prefill(params, {k: t(v) for k, v in b.items()}, s_max=n + 14)
        assert int(cache.pos) == n + 10
        for step in range(4):
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), rtol=0, atol=1e-5,
                                       err_msg=str(step))
            for got, want in zip(cache[:2], cache_r[:2]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
            assert int(cache.pos) == int(cache_r.pos)
            tok = np.asarray(jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32))
            lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, jnp.asarray(tok))
            lg, cache = model.decode_step(params, cache, t(tok))


def test_vlm_patches_change_text_logits(models):
    """Port of the reference's test: text positions attend to the patch
    positions, so moving the patches moves the last text logits."""
    _, _, model, module = models
    b = {k: t(v) for k, v in batch(6, 2, 16).items()}
    with torch.no_grad():
        lo1, _ = model.forward(module.state_tree(), b)
        lo2, _ = model.forward(module.state_tree(), dict(b, patches=b["patches"] + 1.0))
    assert float((lo1[:, -1] - lo2[:, -1]).abs().max()) > 1e-6


def test_bf16_compute_matches_reference():
    """llava's published numerics (bfloat16 params and compute) at smoke
    widths: logits within 4 bf16 roundings of their largest value, the
    loss within 1e-2 relative (as the dense bf16 test)."""
    replace = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_model = ref_get_model(ref_smoke_config(ARCH).replace(**replace))
    ref_p = ref_model.init(jax.random.PRNGKey(7))
    model = get_model(get_smoke_config(ARCH).replace(**replace))
    module = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_p), model, "cpu")
    assert module.embed.dtype == torch.bfloat16
    b = batch(7, 2, 16)
    want_logits, _ = ref_model.forward(ref_p, jax.tree_util.tree_map(jnp.asarray, b))
    want_loss, _ = ref_model.loss(ref_p, jax.tree_util.tree_map(jnp.asarray, b))
    with torch.no_grad():
        logits, _ = model.forward(module.state_tree(), {k: t(v) for k, v in b.items()})
        loss, _ = model.loss(module.state_tree(), {k: t(v) for k, v in b.items()})
    want = np.asarray(want_logits.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -8 * np.abs(want).max())
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-2)


# -- the pipeline's patches --------------------------------------------------


def test_pipeline_draws_patches_and_replays_them():
    """float32 (global_batch, n_patches, d_model) standard normal draws,
    a function of (seed, i): a pipeline restored at cursor 2 replays
    batch 2's tokens and patches."""
    cfg = get_smoke_config(ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4, seed=3,
                    n_patches=cfg.n_patches, d_model=cfg.d_model, family="vlm")
    a = SyntheticTokens(dc, device="cpu")
    batches = [a.next() for _ in range(3)]
    p = batches[0]["patches"]
    assert p.dtype == torch.float32 and tuple(p.shape) == (4, cfg.n_patches, cfg.d_model)
    assert batches[0]["tokens"].shape == (4, 24)
    assert abs(float(p.mean())) < 0.1 and abs(float(p.std()) - 1) < 0.1
    assert not torch.equal(batches[1]["patches"], p)
    b = SyntheticTokens(dc, state={"batch_idx": 2}, device="cpu")
    replay = b.next()
    for k in ("tokens", "patches"):
        assert torch.equal(replay[k], batches[2][k]), k
    # the dense family's batch has no patches
    dense = SyntheticTokens(DataConfig(vocab_size=256, seq_len=8, global_batch=2), device="cpu")
    assert list(dense.next()) == ["tokens"]
