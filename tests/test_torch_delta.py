"""The port's XOR delta against the JAX package's kernel and oracle.

On the CPU the port runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode. Every comparison is exact. The CUDA
kernel itself is checked in tests/test_torch_cuda.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta import delta_ref as jax_delta_ref
from repro.kernels.delta import xor_delta as jax_xor_delta
from repro_torch.kernels.delta import delta_ref, ops, xor_delta


def _words(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _t(w):
    return torch.from_numpy(w.view(np.int32).copy())


# (n_words, fraction of words changed); at most 64 tiles of 1024 words
DELTA_CASES = [
    (1, 1.0),
    (1023, 0.5),
    (4096, 0.0),         # equal streams
    (4096, 1.0),         # every word changed
    (50_003, 0.02),      # ragged tail
]


@pytest.mark.parametrize("n,frac", DELTA_CASES)
def test_xor_delta_matches_pallas_and_oracle(n, frac):
    rng = np.random.default_rng(n)
    prev = _words(rng, n)
    cur = prev.copy()
    hit = rng.random(n) < frac
    cur[hit] ^= _words(rng, int(hit.sum())) | np.uint32(1)
    d, count = xor_delta(_t(cur), _t(prev))
    assert d.dtype == torch.int32 and d.shape == (n,) and count.dim() == 0
    d = d.numpy().view(np.uint32)

    rd, rc = jax_delta_ref(cur, prev)
    np.testing.assert_array_equal(d, rd)
    assert int(count) == rc == int(hit.sum())
    jd, jc = jax_xor_delta(jnp.asarray(cur), jnp.asarray(prev))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert int(count) == int(jc)
    # the port's own copy of the oracle agrees
    pd, pc = delta_ref(cur, prev)
    np.testing.assert_array_equal(pd, rd)
    assert pc == rc


def test_xor_delta_groups(monkeypatch):
    """The plain version's word groups (cut small here) cover the stream."""
    monkeypatch.setattr(ops, "_PLAIN_GROUP_WORDS", 1000)
    rng = np.random.default_rng(9)
    cur, prev = _words(rng, 12_345), _words(rng, 12_345)
    prev[::5] = cur[::5]
    d, count = xor_delta(_t(cur), _t(prev))
    rd, rc = jax_delta_ref(cur, prev)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), rd)
    assert int(count) == rc


def test_xor_delta_rejects_bad_arguments():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal-length"):
        xor_delta(x, x[:7])
    with pytest.raises(TypeError):
        xor_delta(x.float(), x.float())
    d, count = xor_delta(x[:0], x[:0])
    assert d.numel() == 0 and int(count) == 0
