"""The port's MoE FFN and MoE transformers held against the JAX
reference on the CPU.

The same NumPy inputs and parameters go through ``repro.models`` (run
un-jitted, as the reference's own tests run it) and
``repro_torch.models`` with ``device="cpu"``. Routing is held exactly;
float32 outputs, losses and gradients to float32 rounding (the two
packages sum in different orders), each test stating its tolerance.
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
from repro.models import moe as ref_moe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model, moe
from repro_torch.models.config import MoEConfig
from repro_torch.utils.convert import params_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names

MOE = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]


def rng(seed):
    return np.random.default_rng(seed)


def t(x):
    return torch.from_numpy(np.array(x))


def ref_params(arch, seed=0, **replace):
    cfg = ref_smoke_config(arch).replace(**replace)
    model = ref_get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def port_model(arch, params_np, **replace):
    model = get_model(get_smoke_config(arch).replace(**replace))
    return model, params_from_numpy(params_np, model, "cpu")


def tokens(seed, b, s, v):
    return rng(seed).integers(0, v, (b, s)).astype(np.int32)


def ref_route(logits, m, c):
    """The reference's routing (``repro/models/moe.py:37-50``) on given
    float32 logits: ``(sel, pos_sel, keep)``."""
    b, s, e = logits.shape
    k = m.top_k
    _, sel = jax.lax.top_k(logits, k)
    onehot = jax.nn.one_hot(sel, e, dtype=jnp.int32)
    flat = onehot.reshape(b, s * k, e)
    pos = jnp.cumsum(flat, axis=1) - 1
    pos_sel = jnp.sum(pos * flat, axis=-1).reshape(b, s, k)
    keep = pos_sel < c
    return np.asarray(sel), np.asarray(jnp.clip(pos_sel, 0, c - 1)), np.asarray(keep)


# -- capacity and routing ----------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_reference(arch):
    """Integer arithmetic, equal exactly over a sweep of lengths."""
    for ours, theirs in ((get_config(arch).moe, ref_get_config(arch).moe),
                         (get_smoke_config(arch).moe, ref_smoke_config(arch).moe)):
        for s in (1, 2, 3, 5, 16, 31, 100, 511, 576, 1472, 2048, 2049, 4096, 32768):
            assert moe.capacity(ours, s) == ref_moe.capacity(theirs, s), (arch, s)


def test_capacity_at_published_widths():
    qwen, scout = get_config("qwen2-moe-a2.7b").moe, get_config("llama4-scout-17b-a16e").moe
    assert moe.capacity(qwen, 2048) == 171
    assert moe.capacity(scout, 2048) == 160
    assert moe.capacity(qwen, 1) == moe.capacity(scout, 1) == 4   # decode


def _tied_logits(r, b, s, e):
    """Logits drawn from a few levels, so that most rows hold ties
    inside and across the top k."""
    return r.choice(np.float32([-1.0, 0.0, 0.5, 2.0]), size=(b, s, e)).astype(np.float32)


def _skewed_logits(r, b, s, e):
    """A router that prefers expert 0 and then 1: their queues fill past
    capacity and slots drop."""
    x = r.standard_normal((b, s, e)).astype(np.float32)
    x[..., 0] += 4.0
    x[..., 1] += 2.0
    return x


LOGITS = {
    "random": lambda r, b, s, e: r.standard_normal((b, s, e)).astype(np.float32),
    "tied": _tied_logits,
    "skewed": _skewed_logits,
}


@pytest.mark.parametrize("kind", list(LOGITS))
@pytest.mark.parametrize("m", [MoEConfig(n_experts=8, top_k=2), MoEConfig(n_experts=60, top_k=4),
                               MoEConfig(n_experts=16, top_k=1)], ids=["e8k2", "e60k4", "e16k1"])
def test_route_matches_reference_exactly(kind, m):
    """``sel``, ``pos_sel`` and ``keep`` equal the reference's on the
    same float32 logits: ties go to the lower expert index, queue
    positions count in (s, k) order per sequence."""
    b, s = 3, 48
    logits = LOGITS[kind](rng(20), b, s, m.n_experts)
    c = moe.capacity(m, s)
    want = ref_route(jnp.asarray(logits), m, c)
    sel, pos_sel, keep, gates, probs = moe.route(t(logits), m, c)
    for name, got, w in zip(("sel", "pos_sel", "keep"), (sel, pos_sel, keep), want):
        assert np.array_equal(got.numpy(), w), name
    if kind == "skewed":
        assert not keep.all()          # the case drops slots
    if kind == "tied" and m.top_k > 1:
        # rows whose k-th and (k+1)-th logits tie: the case tests order
        srt = -np.sort(-logits, axis=-1)
        assert (srt[..., m.top_k - 1] == srt[..., m.top_k]).sum() > 10
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.softmax(logits, -1)),
                               rtol=0, atol=1e-6)
    top_v = np.take_along_axis(logits, sel.numpy(), -1)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jax.nn.softmax(top_v, -1)),
                               rtol=0, atol=1e-6)


# -- the MoE FFN -------------------------------------------------------------


def _ffn_inputs(arch, seed, *, skew=0.0):
    _, _, ref_np = ref_params(arch, seed=seed)
    p = jax.tree_util.tree_map(lambda a: np.array(a[0]), ref_np["layers"]["moe"])
    p["router"][:, 0] += skew          # skew > 0: expert 0 overflows
    cfg = get_smoke_config(arch)
    x = rng(seed).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("skew", [0.0, 0.5], ids=["balanced", "drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, skew):
    """out and aux within float32 rounding (atol 1e-5 of outputs of
    order 1), with and without capacity drops."""
    cfg, p, x = _ffn_inputs(arch, 21, skew=skew)
    ref_cfg = ref_smoke_config(arch)
    want_out, want_aux = ref_moe.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                                         ref_cfg.moe)
    got_out, got_aux = moe.moe_ffn(t(x), {k: t(v) for k, v in p.items()}, cfg.moe)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-5)
    assert got_aux.dtype == torch.float32
    if skew:
        logits = x @ p["router"]
        c = moe.capacity(cfg.moe, x.shape[1])
        assert not moe.route(t(logits), cfg.moe, c)[2].all()


def test_moe_ffn_tied_logits_match_reference():
    """A router that passes x through (d = E, router = I) feeds logits
    with ties to the whole FFN of both packages: the lower index wins
    on both sides, so the outputs agree to float32 rounding."""
    m = MoEConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=16)
    r = rng(22)
    x = r.choice(np.float32([-1.0, 0.0, 1.0]), size=(2, 20, 8)).astype(np.float32)
    p = {"router": np.eye(8, dtype=np.float32),
         "w_gate": r.standard_normal((8, 8, 16)).astype(np.float32) / 3,
         "w_up": r.standard_normal((8, 8, 16)).astype(np.float32) / 3,
         "w_down": r.standard_normal((8, 16, 8)).astype(np.float32) / 4,
         "shared_gate": r.standard_normal((8, 16)).astype(np.float32) / 3,
         "shared_up": r.standard_normal((8, 16)).astype(np.float32) / 3,
         "shared_down": r.standard_normal((16, 8)).astype(np.float32) / 4}
    from repro.models.config import MoEConfig as RefMoEConfig

    rm = RefMoEConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=16)
    want_out, want_aux = ref_moe.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), rm)
    got_out, got_aux = moe.moe_ffn(t(x), {k: t(v) for k, v in p.items()}, m)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-6)


def test_dropped_slots_keep_the_token_at_the_last_position():
    """A slot past capacity adds nothing: the token that holds position
    C - 1 keeps its full contribution (an assignment at the clipped
    position would overwrite it)."""
    m = MoEConfig(n_experts=2, top_k=1)
    s = 12
    c = moe.capacity(m, s)                      # 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, s, 4, generator=gen)
    p = {"router": torch.zeros(4, 2),           # all logits tie: expert 0, gate 1
         "w_gate": torch.randn(2, 4, 6, generator=gen),
         "w_up": torch.randn(2, 4, 6, generator=gen),
         "w_down": torch.randn(2, 6, 4, generator=gen)}
    out, _ = moe.moe_ffn(x, p, m)
    expert0 = {k: v[:1] for k, v in p.items() if k != "router"}
    want = moe.swiglu_experts(x[:, None, :c], expert0)[0, 0]
    torch.testing.assert_close(out[0, :c], want, rtol=0, atol=1e-6)
    assert torch.equal(out[0, c:], torch.zeros(s - c, 4))


# -- the whole model ---------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_init_has_the_reference_layout(arch):
    ref_model, _, ref_np = ref_params(arch)
    model = get_model(get_smoke_config(arch))
    module = model.init(torch.Generator().manual_seed(0), "cpu")
    got = [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for n, x in flatten_with_names(module.state_tree())[0]]
    want = [(jax.tree_util.keystr(p), x.shape, str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(ref_np)[0]]
    assert got == want
    assert model.param_count() == ref_model.param_count()
    assert {id(p) for p in module.parameters()} == {
        id(x) for _, x in flatten_with_names(module.state_tree())[0]}


@pytest.mark.parametrize("arch", MOE)
def test_published_layout_matches_reference(arch):
    """Names, shapes and dtypes at published widths (meta device against
    ``jax.eval_shape``): llama4-scout's router stays float32 under
    bfloat16 parameters."""
    ref_struct = ref_get_model(ref_get_config(arch)).param_struct()
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(ref_struct)[0]]
    from repro_torch.models.transformer import Transformer

    module = Transformer(get_config(arch), device="meta")
    got = [(n, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for n, x in flatten_with_names(module.state_tree())[0]]
    assert got == want
    dtypes = dict((n, d) for n, _, d in got)
    assert dtypes["['layers']['moe']['router']"] == "float32"


@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 14_315_735_040, 2_689_124_352),
    ("llama4-scout-17b-a16e", 107_769_861_120, 17_172_894_720),
])
def test_param_count_at_published_widths(arch, total, active):
    """Counted on the meta device, equal to the reference's exactly."""
    model, ref_model = get_model(get_config(arch)), ref_get_model(ref_get_config(arch))
    assert model.param_count() == ref_model.param_count() == total
    assert model.param_count(active_only=True) == \
        ref_model.param_count(active_only=True) == active


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_loss_match_reference(arch):
    """Logits within 1e-5, loss, ce and aux within 1e-5 relative
    (float32 compute)."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=1)
    model, module = port_model(arch, ref_np)
    toks = tokens(6, 3, 40, 256)
    want_logits, want_aux = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    want_loss, want_parts = ref_model.loss(ref_p, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux = model.forward(module.state_tree(), {"tokens": t(toks)})
        loss, parts = model.loss(module.state_tree(), {"tokens": t(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    assert float(aux) > 0
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("ce", "aux"):
        assert float(parts[k]) == pytest.approx(float(want_parts[k]), rel=1e-5), k


@pytest.mark.parametrize("arch", MOE)
def test_gradients_match_reference(arch):
    """Every leaf's gradient within 1e-4 of its largest element (float32
    rounding through backward; the routing is piecewise constant, so
    the same selections give the same gradient function)."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=2)
    model, module = port_model(arch, ref_np)
    toks = tokens(7, 2, 32, 256)
    want = jax.grad(lambda p: ref_model.loss(p, {"tokens": jnp.asarray(toks)})[0])(ref_p)
    named = flatten_with_names(module.state_tree())[0]
    loss, _ = model.loss(module.state_tree(), {"tokens": t(toks)})
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want_named = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [n for n, _ in named] == [jax.tree_util.keystr(p) for p, _ in want_named]
    for (n, _), g, (_, w) in zip(named, grads, want_named):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=n)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    """Prefill (capacity of the prompt's length) then three decode
    steps (capacity 4) on the reference's own greedy tokens: logits and
    caches within 1e-5."""
    ref_model, ref_p, ref_np = ref_params(arch, seed=3)
    model, module = port_model(arch, ref_np)
    params = module.state_tree()
    toks = tokens(8, 2, 20, 256)
    cache_r, lg_r = ref_model.prefill(ref_p, {"tokens": jnp.asarray(toks)}, s_max=24)
    with torch.no_grad():
        cache, lg = model.prefill(params, {"tokens": t(toks)}, s_max=24)
        for step in range(4):
            np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), rtol=0, atol=1e-5,
                                       err_msg=str(step))
            for got, want in zip(cache[:2], cache_r[:2]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
            assert int(cache.pos) == int(cache_r.pos)
            tok = np.asarray(jnp.argmax(lg_r, -1)[:, None].astype(jnp.int32))
            lg_r, cache_r = ref_model.decode_step(ref_p, cache_r, jnp.asarray(tok))
            lg, cache = model.decode_step(params, cache, t(tok))


def test_moe_capacity_drops_tokens_deterministically(monkeypatch):
    """Port of the reference's test: the same loss twice, bit for bit,
    on a batch whose routing drops slots."""
    _, _, ref_np = ref_params("qwen2-moe-a2.7b")
    model, module = port_model("qwen2-moe-a2.7b", ref_np)
    toks = t(tokens(9, 2, 16, 256))
    keeps = []

    def recording(logits, m, c):
        out = route(logits, m, c)
        keeps.append(out[2])
        return out

    route = moe.route
    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad():
        l1, _ = model.loss(module.state_tree(), {"tokens": toks})
        l2, _ = model.loss(module.state_tree(), {"tokens": toks})
    assert float(l1) == float(l2)
    assert len(keeps) == 2 * model.cfg.n_layers
    assert not all(bool(k.all()) for k in keeps)      # some slot dropped


def test_bf16_params_with_a_float32_router_cross_both_ways():
    """llama4-scout's numerics (bfloat16 params, float32 router) at smoke
    widths: the reference's params load into the port and come back
    byte for byte, and the port's AdamW moments follow each leaf's
    dtype (float32 for the router, bfloat16 for the rest)."""
    from repro_torch.train import OptConfig, init_opt_state

    replace = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_model, ref_p, ref_np = ref_params("llama4-scout-17b-a16e", seed=4, **replace)
    model, module = port_model("llama4-scout-17b-a16e", ref_np, **replace)
    back = flatten_with_names(tree_to_numpy(module.state_tree()))[0]
    want = jax.tree_util.tree_flatten_with_path(ref_np)[0]
    assert [n for n, _ in back] == [jax.tree_util.keystr(p) for p, _ in want]
    for (n, x), (_, y) in zip(back, want):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n
    dtypes = {n: x.dtype for n, x in flatten_with_names(module.state_tree())[0]}
    assert dtypes.pop("['layers']['moe']['router']") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    mu = flatten_with_names(init_opt_state(module.state_tree(), OptConfig())["mu"])[0]
    assert [x.dtype for _, x in mu] == [p.dtype for _, p in
                                        flatten_with_names(module.state_tree())[0]]
    # bf16 compute through the float32 router: the loss within 1e-2
    toks = tokens(10, 2, 24, 256)
    want_loss, _ = ref_model.loss(ref_p, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        loss, _ = model.loss(module.state_tree(), {"tokens": t(toks)})
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-2)
