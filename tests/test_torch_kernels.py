"""The port's kernel wrappers against the JAX package's kernels and oracles.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode. Every comparison is
exact (tolerance zero): the fused pass is integer arithmetic mod 2**32,
and the quantizer does each step as one IEEE float32 operation.
The dequantizer is one IEEE float32 multiply per value.
The CUDA kernels themselves are checked in tests/test_torch_cuda.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused.ops import fused_precodec as jax_fused
from repro.kernels.fused.ref import fused_ref
from repro.kernels.quantize import dequantize as jax_dequantize
from repro.kernels.quantize import quantize as jax_quantize
from repro.kernels.quantize.ref import dequantize_ref, quantize_ref
from repro_torch.kernels.fused.ref import fused_ref as port_fused_ref
from repro_torch.kernels.fused.ops import (
    digests_from_meta,
    fused_precodec,
    meta_to_numpy,
)
from repro_torch.kernels.quantize import ops as quantize_ops
from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.kernels.quantize.ref import dequantize_ref as port_dequantize_ref
from repro_torch.kernels.quantize.ref import quantize_ref as port_quantize_ref
from repro_torch.utils.convert import tree_from_numpy


def _words(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _port_fused(cur, base, chunk_words):
    c = torch.from_numpy(cur.view(np.int32).copy())
    b = torch.from_numpy(base.view(np.int32).copy())
    delta, meta = fused_precodec(c, b, chunk_words=chunk_words)
    return delta.numpy().view(np.uint32), meta_to_numpy(meta)


# (n_words, chunk_words, fraction of words changed)
FUSED_CASES = [
    (4 * 2048, 2048, 0.01),          # whole chunks
    (3 * 2048 + 777, 2048, 0.3),     # ragged tail
    (1024, 1024, 1.0),               # a single chunk
    (5000, 4096, 0.0),               # clean: nothing changed
]


@pytest.mark.parametrize("n,cw,frac", FUSED_CASES)
def test_fused_matches_pallas_and_oracle(n, cw, frac):
    rng = np.random.default_rng(n + cw)
    base = _words(rng, n)
    cur = base.copy()
    hit = rng.random(n) < frac
    cur[hit] ^= _words(rng, int(hit.sum())) | np.uint32(1)
    delta, meta = _port_fused(cur, base, cw)

    jd, jm = jax_fused(jnp.asarray(cur), jnp.asarray(base), chunk_words=cw)
    np.testing.assert_array_equal(delta, np.asarray(jd))
    np.testing.assert_array_equal(meta, np.asarray(jm))

    rd, counts, digests = fused_ref(cur, base, cw)
    np.testing.assert_array_equal(delta, rd)
    np.testing.assert_array_equal(meta[:, 0], counts)
    np.testing.assert_array_equal(digests_from_meta(meta), digests)


def test_fused_index_wraps_past_2_20_words():
    """Chunks over 4 MiB wrap the position index mod 2**20."""
    cw = (1 << 20) + 2048
    rng = np.random.default_rng(5)
    cur = _words(rng, cw + 3000)
    base = _words(rng, cw + 3000)
    delta, meta = _port_fused(cur, base, cw)
    rd, counts, digests = fused_ref(cur, base, cw)
    np.testing.assert_array_equal(delta, rd)
    np.testing.assert_array_equal(meta[:, 0], counts)
    np.testing.assert_array_equal(digests_from_meta(meta), digests)
    # the port's own copy of the oracle agrees
    for a, b in zip(port_fused_ref(cur, base, cw), (rd, counts, digests)):
        np.testing.assert_array_equal(a, b)


def test_fused_rejects_bad_arguments():
    x = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_precodec(x, x, chunk_words=1000)
    with pytest.raises(ValueError):
        fused_precodec(x, x[:1024], chunk_words=1024)


def _tie_block():
    """absmax 127 (scale exactly 1.0): halves round away from zero, and
    0.49999997 (the float just below 0.5) rounds to 1 because the add of
    0.5 is a float32 add, as the Pallas kernel writes it."""
    b = np.zeros(128, np.float32)
    b[:9] = [127.0, 2.5, -2.5, 126.5, -126.5, 0.5, -0.5, 1.5, -3.5]
    b[9] = np.nextafter(np.float32(0.5), np.float32(0))
    b[10] = -b[9]
    return b


def _quant_cases():
    rng = np.random.default_rng(11)
    # absmax 127 * 1024 in every block: scale 1024 exactly, and the
    # extremes quantize to the clip bounds +-127
    clip = rng.standard_normal(4096).astype(np.float32) * 100
    clip[::128] = 127.0 * 1024
    clip[1::128] = -127.0 * 1024
    return {
        "normal_padded": (rng.standard_normal(3 * 4096 + 200) * 3).astype(np.float32),
        "zeros": np.zeros(4096, np.float32),
        "clip": clip,
        "ties_zero_blocks": np.concatenate(
            [_tie_block(), np.zeros(4096 - 128, np.float32)]
        ),
    }


QUANT_CASES = _quant_cases()
# cases whose scales are exact powers of two (or zero), where the Pallas
# kernel's jitted absmax / 127 is exact too (see test_reference_divergences)
EXACT_SCALE_CASES = ["zeros", "clip", "ties_zero_blocks"]


def _as(x, dtype):
    return np.asarray(jnp.asarray(x, dtype=dtype))


@pytest.mark.parametrize("case", EXACT_SCALE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_pallas(case, dtype):
    x = _as(QUANT_CASES[case], dtype)
    q, s = quantize(tree_from_numpy(x, "cpu"))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", ["normal_padded", "zeros", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_numpy_oracle(case, dtype):
    x = _as(QUANT_CASES[case], dtype)
    q, s = quantize(tree_from_numpy(x, "cpu"))
    x32 = x.astype(np.float32)
    rq, rs = quantize_ref(np.pad(x32, (0, (-len(x32)) % 4096)).reshape(-1, 128))
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(s.numpy(), rs)
    assert q.shape == rq.shape and s.shape == rs.shape


def test_quantize_ties():
    q, s = quantize(torch.from_numpy(_tie_block()))
    assert float(s[0]) == 1.0 and not s[1:].any()
    assert q[0, :11].tolist() == [127, 3, -3, 127, -127, 1, -1, 2, -4, 1, -1]
    assert not q[0, 11:].any() and not q[1:].any()


def test_reference_divergences():
    """The port does each step as one IEEE float32 operation. The two
    references each depart from that in one place:

    * XLA:CPU rewrites the jitted ``absmax / 127.0`` of the Pallas kernel
      (interpret mode) into a multiply by the reciprocal, which is off by
      one ulp for some blocks; ``quantize_ref`` and the port divide.
    * ``quantize_ref`` adds the +-0.5 in float64 (``np.where`` of Python
      floats), so 0.49999997 rounds to 0 there; the Pallas kernel and
      the port add in float32 and give 1.
    """
    x = QUANT_CASES["normal_padded"]
    q, s = quantize(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    rq, rs = quantize_ref(np.pad(x, (0, (-len(x)) % 4096)).reshape(-1, 128))
    assert (np.asarray(js) != rs).any()
    np.testing.assert_array_equal(s.numpy(), rs)
    np.testing.assert_array_equal(q.numpy(), rq)

    tie = _tie_block()
    rq, _ = quantize_ref(tie.reshape(1, 128))
    jq, _ = jax_quantize(jnp.asarray(tie))
    q, _ = quantize(torch.from_numpy(tie))
    assert rq[0, 9] == 0 and np.asarray(jq)[0, 9] == 1 and int(q[0, 9]) == 1


def _same_floats(a, b):
    """Equal bit for bit, except that any NaN matches any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.int32)[~nan], b.view(np.int32)[~nan])


def _dequant_cases():
    """(q, s, n): codes and scales of whole 4096-value tiles (what the
    Pallas wrapper takes), at most 64 tiles."""
    rng = np.random.default_rng(23)
    q, s = quantize_ref((rng.standard_normal((96, 128)) * 5).astype(np.float32))
    nan_s = s.copy()
    nan_s[[3, 40]] = np.nan                 # a NaN scale: that block is NaN
    neg = s.copy()
    neg[7] = -neg[7]                        # a negative scale: -0.0 for zero codes
    zq = q.copy()
    zq[10:42] = 0                           # zero blocks, with their scales
    zs = s.copy()
    zs[10:42] = 0
    return {
        "whole": (q, s, 96 * 128),
        "cut_mid_block": (q, s, 90 * 128 + 77),
        "cut_first_block": (q, s, 5),
        "zero_blocks": (zq, zs, 96 * 128 - 1),
        "nan_scale": (q, nan_s, 96 * 128),
        "negative_scale": (q, neg, 96 * 128),
        "many_tiles": (*quantize_ref(rng.standard_normal((64 * 32, 128)).astype(np.float32)),
                       64 * 4096 - 100),
    }


DEQUANT_CASES = _dequant_cases()


@pytest.mark.parametrize("case", sorted(DEQUANT_CASES))
def test_dequantize_matches_pallas_and_oracle(case):
    q, s, n = DEQUANT_CASES[case]
    got = dequantize(torch.from_numpy(q), torch.from_numpy(s), n=n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    # the oracle first, so that a fault of the JAX path shows as such
    _same_floats(got.numpy(), dequantize_ref(q, s).reshape(-1)[:n])
    _same_floats(got.numpy(), port_dequantize_ref(q, s).reshape(-1)[:n])
    _same_floats(got.numpy(), np.asarray(jax_dequantize(jnp.asarray(q), jnp.asarray(s), n=n)))


def test_dequantize_groups(monkeypatch):
    """The plain version's block groups (cut small here) cover ``n``."""
    monkeypatch.setattr(quantize_ops, "_PLAIN_GROUP_BLOCKS", 7)
    q, s, _ = DEQUANT_CASES["whole"]
    n = 50 * 128 + 3
    got = dequantize(torch.from_numpy(q), torch.from_numpy(s), n=n)
    _same_floats(got.numpy(), dequantize_ref(q, s).reshape(-1)[:n])


def test_dequantize_rejects_bad_arguments():
    q = torch.zeros((4, 128), dtype=torch.int8)
    s = torch.zeros(4)
    with pytest.raises(ValueError):
        dequantize(q, s, n=4 * 128 + 1)
    with pytest.raises(ValueError):
        dequantize(q, s[:3], n=10)
    with pytest.raises(TypeError):
        dequantize(q.float(), s, n=10)
    assert dequantize(q, s, n=0).shape == (0,)


def test_port_quantize_ref_is_the_reference():
    x = QUANT_CASES["normal_padded"]
    blocks = np.pad(x, (0, (-len(x)) % 4096)).reshape(-1, 128)
    for a, b in zip(port_quantize_ref(blocks), quantize_ref(blocks)):
        np.testing.assert_array_equal(a, b)
