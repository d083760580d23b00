"""The port's whole-stream checksum against the JAX package's kernel and
oracle: ``checksum_u32``, ``digest_bytes`` and ``digest_array``.

On the CPU the port runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode. Every comparison is exact: the
checksum is integer arithmetic mod 2**32. The CUDA kernel itself is
checked in tests/test_torch_cuda.py.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum import checksum_u32 as jax_checksum
from repro.kernels.checksum import digest_array as jax_digest_array
from repro.kernels.checksum import digest_bytes as jax_digest_bytes
from repro.kernels.checksum.ref import checksum_ref_np, digest_ref
from repro.kernels.common import bytes_to_u32 as jax_bytes_to_u32
from repro_torch.kernels.checksum import ops
from repro_torch.kernels.checksum.ops import (
    checksum_pair,
    checksum_u32,
    digest_array,
    digest_bytes,
    digest_of,
)
from repro_torch.kernels.common import bytes_to_u32
from repro_torch.utils.convert import tree_from_numpy


def _words(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _port(w):
    return checksum_pair(checksum_u32(torch.from_numpy(w.view(np.int32).copy())))


# at most 64 tiles of 1024 words through the interpret-mode kernel
@pytest.mark.parametrize("n", [0, 1, 3, 1023, 1024, 1025, 4096, 50_003])
def test_checksum_matches_pallas_and_oracle(n):
    w = _words(np.random.default_rng(n), n)
    got = _port(w)
    assert got == checksum_ref_np(w)
    assert got == tuple(int(v) for v in np.asarray(jax_checksum(jnp.asarray(w))))


@pytest.mark.parametrize("group", [1 << 26, 1 << 20, 3000])
def test_checksum_index_wraps_past_2_20_words(monkeypatch, group):
    """The position index wraps mod 2**20; the plain version's word
    groups (cut small here) must not restart it."""
    monkeypatch.setattr(ops, "_PLAIN_GROUP_WORDS", group)
    w = _words(np.random.default_rng(3), 3 * (1 << 20) + 12_345)
    assert _port(w) == checksum_ref_np(w)


def test_checksum_empty_and_types():
    st = checksum_u32(torch.zeros(0, dtype=torch.int32))
    assert st.dtype == torch.int32 and st.shape == (2,) and not st.any()
    with pytest.raises(TypeError):
        checksum_u32(torch.zeros(4, dtype=torch.float32))


@pytest.mark.parametrize("extra", range(8))
@pytest.mark.parametrize("words", [0, 1000])
def test_digest_bytes_matches_pallas_and_oracle(words, extra):
    data = np.random.default_rng(words + extra).bytes(4 * words + extra)
    np.testing.assert_array_equal(
        bytes_to_u32(data).numpy().view(np.uint32), jax_bytes_to_u32(data)
    )
    got = digest_bytes(data, device="cpu")
    assert got == digest_ref(jax_bytes_to_u32(data))
    assert got == jax_digest_bytes(data)


def test_digest_bytes_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        digest_bytes(b"abcd")


def _bytes_oracle(a):
    """digest_ref over an array's bytes, zero-padded to whole words."""
    return digest_ref(jax_bytes_to_u32(np.ascontiguousarray(a).tobytes()))


def _array_cases():
    rng = np.random.default_rng(17)
    bf16 = jnp.asarray(rng.standard_normal(1001).astype(np.float32), jnp.bfloat16)
    return {
        "float32": rng.standard_normal((33, 65)).astype(np.float32),
        "bfloat16_odd": np.asarray(bf16),
        "float16_odd": rng.standard_normal(777).astype(np.float16),
        "int8_ragged": rng.integers(-128, 128, 4097, dtype=np.int8),
        "int32": rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32),
        "int64": rng.integers(-(2**62), 2**62, 3001, dtype=np.int64),
        "float64": rng.standard_normal(999),
        "scalar": np.float32(3.5),
    }


ARRAY_CASES = _array_cases()


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_digest_array_matches_pallas_and_oracle(case):
    a = ARRAY_CASES[case]
    got = digest_of(digest_array(tree_from_numpy(a, "cpu")))
    assert got == _bytes_oracle(a)
    with jax.enable_x64(True):          # keeps int64 / float64 64-bit
        want = np.asarray(jax_digest_array(jnp.asarray(a))).astype(np.uint64)
    assert got == int((want[1] << np.uint64(32)) | want[0])


def test_digest_array_bool_is_its_bytes():
    """JAX's ``digest_array`` raises on bool (``bitcast_convert_type``
    takes no bool); the port digests the bytes a bool tensor holds,
    which is what JAX's kernel gives for the same values as uint8."""
    b = np.random.default_rng(2).random(1003) < 0.5
    got = digest_of(digest_array(torch.from_numpy(b)))
    assert got == _bytes_oracle(b)
    want = np.asarray(jax_digest_array(jnp.asarray(b.astype(np.uint8)))).astype(np.uint64)
    assert got == int((want[1] << np.uint64(32)) | want[0])
    with pytest.raises(TypeError):
        jax_digest_array(jnp.asarray(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int64])
@pytest.mark.parametrize("start", [1, 2, 3])
def test_digest_array_of_a_view(dtype, start):
    """A view that starts inside its storage digests as its own bytes."""
    x = torch.from_numpy(np.random.default_rng(start).standard_normal(4099)).to(dtype)
    v = x[start:]
    got = digest_of(digest_array(v))
    assert got == _bytes_oracle(v.contiguous().view(torch.uint8).numpy())
