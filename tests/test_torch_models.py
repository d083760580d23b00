"""The port's dense model held against the JAX reference on the CPU.

The same NumPy inputs and parameters go through ``repro.models`` (run
un-jitted, as the reference's own tests run it) and
``repro_torch.models`` with ``device="cpu"``. Each test states its
tolerance; float32 cases are held to rounding (the two packages sum in
different orders), the bf16-compute case to bf16 resolution.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import get_model as ref_get_model
from repro.models import layers as ref_layers
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import attention, get_model, layers
from repro_torch.utils.convert import copy_tree_, params_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names

DENSE = ["qwen1.5-0.5b", "tinyllama-1.1b"]
# the families whose layout and forward/loss this file holds: the dense
# ones, and whisper (its batch carries frames)
LAYOUT = DENSE + ["whisper-small"]


def rng(seed):
    return np.random.default_rng(seed)


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


def batch(arch, seed, b, s):
    """A NumPy batch of ``b`` x ``s`` tokens for ``arch``'s smoke config,
    with an audio model's frames."""
    cfg = get_smoke_config(arch)
    out = {"tokens": tokens(seed, b, s, cfg.vocab_size)}
    if cfg.family == "audio":
        out["frames"] = rng(seed + 1).standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- structure -------------------------------------------------------------


@pytest.mark.parametrize("arch", LAYOUT)
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
    # the tree's leaves are the module's own parameters
    assert {id(p) for p in module.parameters()} == {
        id(x) for _, x in flatten_with_names(module.state_tree())[0]}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "tinyllama-1.1b", "qwen2-72b", "llama3-405b"])
def test_param_count_at_published_widths(arch):
    """Counted on the meta device: no memory, the reference's number."""
    from repro.configs import get_config as ref_get_config

    assert get_model(get_config(arch)).param_count() == \
        ref_get_model(ref_get_config(arch)).param_count()


def test_init_is_a_function_of_the_generator():
    model = get_model(get_smoke_config("qwen1.5-0.5b"))
    a, b, c = (tree_to_numpy(model.init(torch.Generator().manual_seed(s), "cpu").state_tree())
               for s in (3, 3, 4))
    fa, fb, fc = (flatten_with_names(x)[0] for x in (a, b, c))
    assert all(x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(fa, fb))
    assert any(x.tobytes() != y.tobytes() for (_, x), (_, y) in zip(fa, fc))
    # dense weights have the reference's std 1/sqrt(fan_in); norms start at 0
    wq = a["layers"]["wq"]
    assert wq.std() == pytest.approx(1 / np.sqrt(wq.shape[1]), rel=0.05)
    assert not a["layers"]["ln1"].any() and not a["layers"]["bq"].any()


def test_copy_tree_checks_names_shapes_and_dtypes():
    _, _, ref_np = ref_params("tinyllama-1.1b")
    _, module = port_model("tinyllama-1.1b", ref_np)
    bad = jax.tree_util.tree_map(np.copy, ref_np)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        copy_tree_(module.state_tree(), bad)
    del bad["out"]
    with pytest.raises(ValueError, match="structure"):
        copy_tree_(module.state_tree(), bad)


@pytest.mark.parametrize("arch", ["whisper-small"])
def test_families_not_ported_yet_raise(arch):
    """Every family of the reference is ported (whisper's last); a family
    the port does not know (``arch``'s config under another family name)
    raises ``ValueError`` wherever the facade looks the family up."""
    model = get_model(get_smoke_config(arch).replace(family="speech"))
    with pytest.raises(ValueError, match="unknown family 'speech'"):
        model.init(torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="unknown family"):
        model.param_struct()
    with pytest.raises(ValueError, match="unknown family"):
        model.batch_struct(2, 8)


def test_configs_are_the_reference_configs():
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import get_config as ref_get_config

    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                             (get_smoke_config(arch), ref_smoke_config(arch))):
            a, b = vars(ours).copy(), vars(theirs).copy()
            moe_a, moe_b = a.pop("moe"), b.pop("moe")
            assert (moe_a is None) == (moe_b is None), arch
            if moe_a is not None:
                assert _common_fields_equal(moe_a, moe_b), arch
            assert _common_fields_equal(ours, theirs, a, b), arch
            assert str(ours.pdt) == "torch." + str(theirs.pdt)


def _common_fields_equal(ours, theirs, a=None, b=None) -> bool:
    """The reference's fields equal, and the port's own fields (MLA, the
    MoE layer's held share and routing, leading dense layers) at their
    defaults, which is what the reference computes."""
    import dataclasses

    a = vars(ours).copy() if a is None else a
    b = vars(theirs).copy() if b is None else b
    defaults = {f.name: f.default for f in dataclasses.fields(ours)}
    own = set(a) - set(b)
    return ({k: a[k] for k in b} == b
            and all(a[k] == defaults[k] for k in own))


# -- layers ----------------------------------------------------------------


def test_rms_norm_matches_reference():
    r = rng(1)
    x = r.standard_normal((3, 7, 96)).astype(np.float32)
    scale = (0.1 * r.standard_normal(96)).astype(np.float32)
    want = np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = layers.rms_norm(t(x), t(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_rope_matches_reference():
    r = rng(2)
    x = r.standard_normal((2, 40, 4, 24)).astype(np.float32)
    pos = np.arange(40)[None, :]
    want = np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = layers.apply_rope(t(x), t(pos), 10_000.0).numpy()
    # positions up to 39 radians: sin/cos of either library within 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_swiglu_matches_reference():
    r = rng(3)
    x = r.standard_normal((2, 9, 96)).astype(np.float32)
    wg, wu = (r.standard_normal((96, 192)).astype(np.float32) / 10 for _ in range(2))
    wd = r.standard_normal((192, 96)).astype(np.float32) / 14
    want = np.asarray(ref_layers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))
    got = layers.swiglu(t(x), t(wg), t(wu), t(wd)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_masks_match_reference():
    for q_offset in (0, 5):
        assert np.array_equal(layers.causal_mask(6, 11, q_offset=q_offset).numpy(),
                              np.asarray(ref_layers.causal_mask(6, 11, q_offset=q_offset)))
        assert np.array_equal(layers.window_mask(6, 11, 3, q_offset=q_offset).numpy(),
                              np.asarray(ref_layers.window_mask(6, 11, 3, q_offset=q_offset)))


# -- attention: the three paths --------------------------------------------

# (s_q, chunk_q, window): unchunked; query-chunked (s_q = 2 chunk_q);
# banded local window (s_q = 4 chunk_q, band = window + chunk_q < s_k)
ATTN_PATHS = {
    "unchunked": (24, None, None),
    "chunked": (32, 16, None),
    "banded": (64, 16, 8),
}


@pytest.mark.parametrize("path", list(ATTN_PATHS))
def test_attention_paths_match_reference(path):
    s, chunk_q, window = ATTN_PATHS[path]
    r = rng(4)
    q = r.standard_normal((2, s, 8, 16)).astype(np.float32)
    k, v = (r.standard_normal((2, s, 2, 16)).astype(np.float32) for _ in range(2))   # GQA 8/2
    want = np.asarray(ref_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, chunk_q=chunk_q))
    got = attention.attention(t(q), t(k), t(v), window=window, chunk_q=chunk_q).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if chunk_q is not None:
        # each path equals the one-block reference with the full mask
        plain = attention.attention(t(q), t(k), t(v), window=window, chunk_q=None).numpy()
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)


def test_repeat_kv_groups_like_the_reference():
    k = rng(5).standard_normal((1, 3, 2, 4)).astype(np.float32)
    want = np.asarray(ref_attention.repeat_kv(jnp.asarray(k), 6))
    assert np.array_equal(attention.repeat_kv(t(k), 6).numpy(), want)
    with pytest.raises(ValueError, match="multiple"):
        attention.repeat_kv(t(k), 5)


# -- the whole model -------------------------------------------------------


@pytest.mark.parametrize("arch", LAYOUT)
def test_forward_and_loss_match_reference(arch):
    ref_model, ref_p, ref_np = ref_params(arch, seed=1)
    model, module = port_model(arch, ref_np)
    b = batch(arch, 6, 3, 40)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: t(v) for k, v in b.items()}
    want_logits, _ = ref_model.forward(ref_p, jb)
    want_loss, _ = ref_model.loss(ref_p, jb)
    with torch.no_grad():
        logits, aux = model.forward(module.state_tree(), tb)
        loss, parts = model.loss(module.state_tree(), tb)
    # float32 compute: rounding only
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(aux) == 0.0 and float(parts["ce"]) == float(loss)
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    with torch.no_grad():
        assert torch.equal(module(tb["tokens"], **extra)[0], logits)    # the nn.Module call


def test_chunked_forward_matches_reference():
    """Forward through the query-chunked path (s = 2 chunk_q) and the
    banded window path (window set, s = 4 chunk_q)."""
    for replace in ({"chunk_q": 16}, {"chunk_q": 16, "window": 12}):
        ref_model, ref_p, ref_np = ref_params("tinyllama-1.1b", seed=2, **replace)
        model, module = port_model("tinyllama-1.1b", ref_np, **replace)
        s = 64 if "window" in replace else 32
        toks = tokens(7, 2, s, 256)
        want, _ = ref_model.loss(ref_p, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            got, _ = model.loss(module.state_tree(), {"tokens": t(toks)})
        assert float(got) == pytest.approx(float(want), rel=1e-5), replace


def test_bf16_compute_matches_reference():
    """qwen1.5-0.5b's published numerics (float32 params, bfloat16
    compute) at smoke widths. bf16 keeps 8 bits of mantissa and the two
    packages round in different places (matmul outputs, the embedding
    cast, the residual adds), so logits agree to a few bf16 ulps of
    their scale and the loss to 1e-2 relative."""
    ref_model, ref_p, ref_np = ref_params("qwen1.5-0.5b", seed=3, compute_dtype="bfloat16")
    model, module = port_model("qwen1.5-0.5b", ref_np, compute_dtype="bfloat16")
    toks = tokens(8, 2, 32, 256)
    want_logits, _ = ref_model.forward(ref_p, {"tokens": jnp.asarray(toks)})
    want_loss, _ = ref_model.loss(ref_p, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, _ = model.forward(module.state_tree(), {"tokens": t(toks)})
        loss, _ = model.loss(module.state_tree(), {"tokens": t(toks)})
    assert logits.dtype == torch.bfloat16
    want = np.asarray(want_logits.astype(jnp.float32))
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -8 * np.abs(want).max())
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_remat_changes_no_bit(arch):
    """Recomputing each block in backward gives the same loss and
    gradients, bit for bit (the same ops run again on the CPU)."""
    _, _, ref_np = ref_params(arch, seed=4)
    model, module = port_model(arch, ref_np)
    toks = t(tokens(9, 2, 24, 256))
    out = []
    for remat in (False, True):
        leaves = [p for _, p in flatten_with_names(module.state_tree())[0]]
        loss, _ = model.loss(module.state_tree(), {"tokens": toks}, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
