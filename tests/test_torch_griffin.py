"""The port's Griffin (RecurrentGemma) family held against the JAX
reference on the CPU.

The same NumPy inputs and parameters go through ``repro.models.griffin``
(un-jitted, as the reference's own tests run it; the train steps through
``jax.jit(build_train_step)`` with no mesh) and
``repro_torch.models.griffin`` with ``device="cpu"``, at the smoke config
(``src/repro/configs/recurrentgemma_2b.py::smoke_config``: window 8,
float32): the RG-LRU (its coefficients, the parallel scan in both of
``rglru_scan``'s branches, the scan against a loop of ``rglru_step``),
the ring cache built from a prompt, then the whole model through the
``check_*`` helpers of ``tests/test_torch_xlstm.py``. Each test states
its tolerance; float32 cases are held to rounding, ring placements
exactly.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import get_model as ref_get_model
from repro.models import griffin as ref_griffin
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, griffin
from test_torch_xlstm import (
    check_cache_struct,
    check_decode_leaves_its_state_unchanged,
    check_decode_matches_teacher_forcing,
    check_forward_and_loss,
    check_generate_matches_reference,
    check_gradients,
    check_jax_snapshot_continues_in_port,
    check_layout,
    check_port_train_state_restores_in_reference,
    check_prefill_and_decode,
    check_published_layout,
    check_reference_train_state_restores_into_port,
    check_remat_changes_no_bit,
    check_run_resumes_bit_exact,
    check_smoke_forward_and_train_step,
    check_smoke_prefill_decode,
    check_snapshot_resume,
    check_train_steps,
    close,
    port_model,
    ref_params,
    ref_train_steps,
    rng,
    t,
    tokens,
)

ARCH = "recurrentgemma-2b"


def _rglru_params(seed, d):
    """An RG-LRU block's gate parameters with biases and ``lam`` spread
    (init leaves them constant), float32."""
    r = rng(seed)
    return {"w_r": (r.standard_normal((d, d)) * 0.2).astype(np.float32),
            "b_r": r.standard_normal(d).astype(np.float32),
            "w_i": (r.standard_normal((d, d)) * 0.2).astype(np.float32),
            "b_i": r.standard_normal(d).astype(np.float32),
            "lam": (0.65 + 0.5 * r.standard_normal(d)).astype(np.float32)}


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tp(p):
    return {k: t(v) for k, v in p.items()}


# -- RG-LRU -------------------------------------------------------------------


def test_rglru_coeffs_match_reference():
    """a = exp(-8 softplus(lam) r) and b: float32 rounding, 1e-6."""
    p = _rglru_params(1, 32)
    x = rng(1).standard_normal((2, 9, 32)).astype(np.float32)
    want = ref_griffin._rglru_coeffs(_jp(p), jnp.asarray(x))
    for got, w in zip(griffin._rglru_coeffs(_tp(p), t(x)), want):
        close(got, w, 1e-6)


@pytest.mark.parametrize("b,s", [(2, 64), (1, 8704)], ids=["parallel", "chunked"])
def test_rglru_scan_matches_reference(b, s):
    """``rglru_scan`` in both branches: the parallel scan at s = 64, and
    the chunked scan at s = 8704 = 17 x 512 (> 8192), whose hidden state
    carries across 16 chunk boundaries. The doubling scan and JAX's
    associative scan combine in other orders: 2e-6 of outputs of order
    1."""
    d = 16
    p = _rglru_params(2, d)
    x = rng(2).standard_normal((b, s, d)).astype(np.float32)
    want = ref_griffin.rglru_scan(_jp(p), jnp.asarray(x))
    got = griffin.rglru_scan(_tp(p), t(x))
    assert np.isfinite(got.numpy()).all()
    close(got, want, 2e-6)


def test_rglru_scan_matches_a_loop_of_steps():
    """Within the port: the parallel scan equals the recurrence run one
    ``rglru_step`` at a time from h = 0, to 2e-6, over 300 tokens whose
    cumulative decay underflows float32 (the scan never divides by it)."""
    d = 16
    p = _tp(_rglru_params(3, d))
    x = t(rng(3).standard_normal((2, 300, d)).astype(np.float32))
    a, _ = griffin._rglru_coeffs(p, x)
    assert float(torch.log(a).sum(1).max()) < -200     # prod(a) is far below float32's range
    h = torch.zeros(2, d)
    steps = []
    for i in range(x.shape[1]):
        h, y = griffin.rglru_step(p, h, x[:, i])
        steps.append(y)
    close(griffin.rglru_scan(p, x), torch.stack(steps, 1), 2e-6)


@pytest.mark.parametrize("s", [5, 8, 13], ids=["below", "equal", "above"])
def test_ring_from_full_matches_reference_exactly(s):
    """The last ``window`` roped keys and values at slot pos % window,
    and ``slot_pos``, for a prompt below, equal to and above the smoke
    window (8): equal exactly (pure placement)."""
    cfg, rcfg = get_smoke_config(ARCH), ref_smoke_config(ARCH)
    r = rng(s)
    k, v = (r.standard_normal((2, s, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
            for _ in range(2))
    want = ref_griffin._ring_from_full(jnp.asarray(k), jnp.asarray(v), s, cfg.window, rcfg)
    got = griffin._ring_from_full(t(k), t(v), s, cfg.window, cfg)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype and np.array_equal(got[key].numpy(), w), key


def test_attn_block_matches_reference():
    """A local-attention block (RoPE, MQA 4/1, window 8, GeGLU MLP) over
    20 tokens: 1e-5."""
    cfg, rcfg = get_smoke_config(ARCH), ref_smoke_config(ARCH)
    p = {k: v.detach().numpy().copy() for k, v in
         griffin.init_block(cfg, "attn", torch.Generator().manual_seed(4), "cpu").items()}
    x = rng(4).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(20)[None]
    want = ref_griffin.attn_block(_jp(p), rcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        close(griffin.attn_block(_tp(p), cfg, t(x), t(pos)), want, 1e-5)


# -- the whole model ----------------------------------------------------------


def test_init_has_the_reference_layout():
    """Also: the gate leaves stay float32 under bfloat16 parameters, so
    their AdamW moments are float32 too."""
    check_layout(ARCH)
    from repro_torch.train import OptConfig, init_opt_state

    model = get_model(get_smoke_config(ARCH).replace(param_dtype="bfloat16"))
    tree = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    float32 = {name for name, p in tree["blocks"][0].items() if p.dtype == torch.float32}
    assert float32 == {"w_r", "b_r", "w_i", "b_i", "lam"}
    assert tree["blocks"][2]["wq"].dtype == torch.bfloat16
    mu = init_opt_state(tree, OptConfig())["mu"]
    assert mu["blocks"][0]["lam"].dtype == torch.float32
    assert mu["blocks"][0]["w_x"].dtype == torch.bfloat16


def test_param_count_at_published_widths():
    check_published_layout(ARCH, 2_894_574_080)


def test_forward_and_loss_match_reference():
    check_forward_and_loss(ARCH)


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


def test_window_attention_ignores_far_past():
    """Port of ``tests/test_models.py::test_window_attention_ignores_far_past``:
    position 0 lies outside every window at the last position (the
    RG-LRU carries it, decayed by about e^-4 a token at init): the
    logits stay finite and well-formed."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    toks = t(tokens(5, 1, 20, cfg.vocab_size))
    toks2 = toks.clone()
    toks2[:, 0] = (toks[:, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        f1, _ = model.forward(params, {"tokens": toks})
        f2, _ = model.forward(params, {"tokens": toks2})
    assert bool(torch.isfinite(f1).all()) and bool(torch.isfinite(f2).all())
    assert f1.shape == f2.shape == (1, 20, cfg.vocab_size)


@pytest.mark.parametrize("s", [6, 20], ids=["inside_window", "ring_wraps"])
def test_prefill_and_decode_match_reference(s):
    """A prompt shorter than the window, and one longer (the ring wraps
    before the first decode step and again during decode): logits and
    every state leaf (ring k/v, ``slot_pos``, RG-LRU h and conv) within
    2e-5, ``slot_pos`` and ``pos`` exactly."""
    check_prefill_and_decode(ARCH, s=s, steps=6)


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


# -- train states across the packages, and the trainer ------------------------


def test_reference_train_state_restores_into_port(tmp_path):
    check_reference_train_state_restores_into_port(ARCH, tmp_path)


def test_port_train_state_restores_in_reference(tmp_path):
    """bf16 compute over float32 parameters, with the float32 gate leaves
    beside them: byte for byte in ``repro``."""
    check_port_train_state_restores_in_reference(ARCH, tmp_path)


def test_run_resumes_bit_exact(tmp_path):
    check_run_resumes_bit_exact(ARCH, tmp_path)
