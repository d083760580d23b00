"""The port's mesh-free launch tooling held against the reference.

``repro_torch.launch.hlo_analysis`` is a verbatim copy of the reference's
text-only module: on ``tests/test_hlo_analysis.py``'s toy module and on
the text of a nested scan that JAX compiles here, both give the same
results exactly. ``repro_torch.launch.roofline`` keeps the reference's
``RooflineTerms`` and ``model_flops`` with the H100 SXM5's constants.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlo_analysis as ref_hlo
from repro.launch import roofline as ref_roofline
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch.roofline import (
    DCN_BW,
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    RooflineTerms,
    collective_bytes,
    model_flops,
)
from test_hlo_analysis import HLO_TOY


def _nested_scan_text():
    """The compiled CPU HLO of a scan of 6 (32 x 32) matmuls inside a
    scan of 5."""
    def f(x, w):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            y, _ = jax.lax.scan(inner, c, None, length=6)
            return y, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y

    s = jax.ShapeDtypeStruct((32, 32), jnp.float32)
    return jax.jit(f).lower(s, s).compile().as_text()


@pytest.fixture(scope="module")
def texts():
    return {"toy": HLO_TOY, "nested_scan": _nested_scan_text()}


@pytest.mark.parametrize("which", ["toy", "nested_scan"])
def test_analyze_hlo_equals_the_reference(texts, which):
    """Every field of ``HloCost`` (flops, bytes, collectives by kind, the
    while loops and their trips) and the split into computations, equal."""
    text = texts[which]
    got, want = hlo_analysis.analyze_hlo(text), ref_hlo.analyze_hlo(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    comps, ref_comps = hlo_analysis.split_computations(text), ref_hlo.split_computations(text)
    assert {k: dataclasses.asdict(c) for k, c in comps.items()} == \
        {k: dataclasses.asdict(c) for k, c in ref_comps.items()}
    assert collective_bytes(text) == ref_roofline.collective_bytes(text)
    if which == "nested_scan":
        assert got.flops == 5 * 6 * 2 * 32 ** 3


def test_split_and_multipliers():
    """``tests/test_hlo_analysis.py::test_split_and_multipliers`` on the
    port's copy."""
    comps = hlo_analysis.split_computations(HLO_TOY)
    assert set(comps) == {"body", "cond", "sum", "main"}
    cost = hlo_analysis.analyze_hlo(HLO_TOY)
    assert cost.flops == 12 * 2 * 8 * 8 * 8
    assert cost.collectives["all-reduce"] == 12 * 8 * 8 * 4
    assert cost.n_while == 1
    assert cost.max_trip == 12


def test_hlo_analysis_is_a_verbatim_copy():
    """The source equals the reference's but for the docstring line that
    names it."""
    ours = inspect.getsource(hlo_analysis).splitlines()
    theirs = inspect.getsource(ref_hlo).splitlines()
    assert ours[2] == "A verbatim copy of ``repro/launch/hlo_analysis.py`` (it reads text only)."
    assert ours[:2] + ours[4:] == theirs


def test_roofline_terms_math():
    """``tests/test_hlo_analysis.py::test_roofline_terms_math`` restated
    with the H100's constants: one second of peak bf16 work and one second
    of HBM traffic; its ``model_flops`` asserts hold exactly."""
    t = RooflineTerms(
        flops_per_dev=PEAK_FLOPS, bytes_per_dev=HBM_BW, coll_bytes_per_dev=0.0,
        n_chips=4, model_flops_global=PEAK_FLOPS * 4,
    )
    assert t.compute_s == 1.0
    assert t.memory_s == 1.0
    assert t.dominant == "compute"
    assert t.roofline_fraction == 1.0
    assert t.useful_flops_ratio == 1.0
    assert model_flops("train", 10, 2, 3) == 6 * 10 * 6
    assert model_flops("decode", 10, 4, 999) == 2 * 10 * 4
    assert model_flops("prefill", 10, 4, 3) == 2 * 10 * 12
    with pytest.raises(ValueError):
        model_flops("serve", 1, 1, 1)
    link = RooflineTerms(flops_per_dev=0.0, bytes_per_dev=0.0, coll_bytes_per_dev=LINK_BW,
                         n_chips=1, model_flops_global=0.0)
    assert link.collective_s == 1.0 and link.dominant == "collective"


def test_constants_are_the_h100s():
    """The H100 SXM5 datasheet's dense bf16 rate, HBM3 rate, one
    direction of NVLink 4 and one NDR port (``chip_smoke.py`` bounds its
    kernels by this ``HBM_BW``); no TPU figure is left."""
    assert (PEAK_FLOPS, HBM_BW, LINK_BW, DCN_BW) == (989.4e12, 3.35e12, 450e9, 50e9)
    assert "TPU" not in inspect.getsource(roofline)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_and_row_equal_the_reference(kind):
    """``model_flops`` and every field of ``RooflineTerms.row()`` but the
    three hardware terms (and those derived from them) equal the
    reference's on the same numbers."""
    assert model_flops(kind, 239_435_520, 16, 448) == \
        ref_roofline.model_flops(kind, 239_435_520, 16, 448)
    args = dict(flops_per_dev=3e15, bytes_per_dev=2e12, coll_bytes_per_dev=1e10, n_chips=8,
                model_flops_global=2e16, coll_breakdown={"all-reduce": 5, "all-gather": 0})
    got, want = RooflineTerms(**args).row(), ref_roofline.RooflineTerms(**args).row()
    hw = {"compute_s", "memory_s", "collective_s", "dominant", "roofline_fraction"}
    assert {k: v for k, v in got.items() if k not in hw} == \
        {k: v for k, v in want.items() if k not in hw}
    assert got["compute_s"] == 3e15 / PEAK_FLOPS and got["memory_s"] == 2e12 / HBM_BW
