"""The port's DevicePrecodec (on the CPU, with the kernels' plain
versions) against the JAX package's DevicePrecodec (Pallas in interpret
mode): streams, leaf tables, dirty masks, digests and deltas, for full
and delta stages, under precodec "none" and "int8"."""
import os
from dataclasses import astuple

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precodec import DevicePrecodec as JaxPrecodec
from repro.core.precodec import _is_float_leaf
from repro.core.precodec import dequantize_tree_reference as jax_dequantize_tree_reference
from repro.core.serialize import serialize_tree as jax_serialize
from repro.kernels.fused.ref import chunk_digests_ref
from repro.kernels.quantize.ref import dequantize_ref, quantize_ref
from repro_torch.core.precodec import (
    DevicePrecodec,
    dequantize_tree,
    dequantize_tree_reference,
    quantize_tree,
)
from repro_torch.core.serialize import serialize_tree
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from test_precodec_device import mixed_state

CHUNK = 4096


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _states():
    s1 = _numpy(mixed_state())
    s2 = dict(s1, w=s1["w"] + np.float32(0.25))   # one leaf changes
    return s1, s2


def _quantize_ref_tree(state):
    """The int8 transform with every block quantized by quantize_ref."""

    def f(leaf):
        if not _is_float_leaf(leaf):
            return leaf
        x = np.asarray(leaf, np.float32).reshape(-1)
        q, s = quantize_ref(np.pad(x, (0, (-len(x)) % 4096)).reshape(-1, 128))
        return {"q": q, "s": s}

    return jax.tree_util.tree_map(f, state)


def _rows(leaves):
    return [astuple(l) for l in leaves]


def _expected(states, precodec):
    """Streams and leaf tables the port must stage: the JAX package's
    DevicePrecodec under "none"; under "int8" its host serializer over
    quantize_ref's codes (the kernels' IEEE semantics; see
    test_torch_kernels.py::test_reference_divergences)."""
    if precodec == "none":
        dev = JaxPrecodec(chunk_size=CHUNK, precodec="none")
        full = dev.consume(dev.stage(1, jax.tree_util.tree_map(jnp.asarray, states[0])))
        delta = dev.consume(
            dev.stage(2, jax.tree_util.tree_map(jnp.asarray, states[1]), base_step=1),
            full.stream,
        )
        dev.close()
        return full, delta
    return [jax_serialize(_quantize_ref_tree(s)) for s in states]


@pytest.mark.parametrize("precodec", ["none", "int8"])
def test_staged_full_and_delta_match_reference(precodec):
    states = _states()
    exp = _expected(states, precodec)
    dev = DevicePrecodec(chunk_size=CHUNK, precodec=precodec, device="cpu")
    full = dev.consume(dev.stage(1, tree_from_numpy(states[0], "cpu")))
    delta = dev.consume(
        dev.stage(2, tree_from_numpy(states[1], "cpu"), base_step=1), full.stream
    )
    dev.close()

    if precodec == "none":
        e_streams = [bytes(e.stream) for e in exp]
        e_leaves = [_rows(e.leaves) for e in exp]
        np.testing.assert_array_equal(delta.mask, exp[1].mask)
        np.testing.assert_array_equal(full.digests, exp[0].digests)
        np.testing.assert_array_equal(delta.digests, exp[1].digests)
        assert sorted(delta.deltas) == sorted(exp[1].deltas)
        for k, v in exp[1].deltas.items():
            np.testing.assert_array_equal(delta.deltas[k], v)
    else:
        e_streams = [bytes(s) for s, _ in exp]
        e_leaves = [_rows(l) for _, l in exp]
    for got, want, rows in zip((full, delta), e_streams, e_leaves):
        assert bytes(got.stream) == want
        assert _rows(got.leaves) == rows
        words = np.frombuffer(want + bytes((-len(want)) % 4), np.uint32)
        np.testing.assert_array_equal(got.digests, chunk_digests_ref(words, CHUNK // 4))
    assert full.base_step is None and bool(full.mask.all())
    assert delta.base_step == 1
    # the dirty mask is exactly the set of chunks whose bytes changed
    a, b = np.frombuffer(e_streams[0], np.uint8), np.frombuffer(e_streams[1], np.uint8)
    n = len(delta.mask)
    changed = [
        not np.array_equal(a[i * CHUNK : (i + 1) * CHUNK], b[i * CHUNK : (i + 1) * CHUNK])
        for i in range(n)
    ]
    np.testing.assert_array_equal(delta.mask, changed)
    assert 0 < delta.mask.sum() < n
    for k, v in delta.deltas.items():
        np.testing.assert_array_equal(
            v, np.bitwise_xor(a[k * CHUNK : (k + 1) * CHUNK], b[k * CHUNK : (k + 1) * CHUNK])
        )


@pytest.mark.parametrize("precodec", ["none", "int8"])
def test_staged_stream_equals_host_path(precodec):
    state = tree_from_numpy(_states()[0], "cpu")
    dev = DevicePrecodec(chunk_size=CHUNK, precodec=precodec, device="cpu")
    bufs = dev.consume(dev.stage(1, state))
    dev.close()
    tree = quantize_tree(state) if precodec == "int8" else state
    stream, leaves = serialize_tree(tree)
    assert bytes(bufs.stream) == bytes(stream) and bufs.leaves == leaves


def test_in_place_update_after_stage_is_not_saved():
    state = tree_from_numpy(_states()[0], "cpu")
    want, _ = serialize_tree(state)
    dev = DevicePrecodec(chunk_size=CHUNK, device="cpu")
    staged = dev.stage(1, state)
    for leaf in state.values():
        if leaf.dtype != torch.bool:
            leaf.add_(1)          # a torch optimizer's in-place step
    bufs = dev.consume(staged)
    dev.close()
    assert bytes(bufs.stream) == bytes(want)


def test_dequantize_tree_inverts_to_target_dtypes():
    s1 = _states()[0]
    state = tree_from_numpy(s1, "cpu")
    back = dequantize_tree(quantize_tree(state), state)
    for k, v in state.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
    rq = _quantize_ref_tree(s1)
    x = (rq["w"]["q"].astype(np.float32) * rq["w"]["s"][:, None]).reshape(-1)
    np.testing.assert_array_equal(back["w"].numpy().reshape(-1), x[: back["w"].numel()])
    torch.testing.assert_close(back["i"], state["i"], rtol=0, atol=0)


def _dequant_target():
    rng = np.random.default_rng(9)
    h = rng.standard_normal((33, 130)).astype(np.float32) * 7
    return {
        "a": rng.standard_normal((64, 128)).astype(np.float32),
        "b": rng.standard_normal(5000).astype(np.float32) * 40,
        "h": np.asarray(jnp.asarray(h, jnp.bfloat16)),
        "small": np.float32(3.5),                     # below the quantize floor
        "ints": np.arange(10, dtype=np.int32),        # not quantized
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_dequantize_tree_reference_matches_host_path_and_jax():
    """The per-leaf kernel restore is the spec of the host restore, and
    equals the JAX package's spec on the same codes. Each quantized leaf
    is also held against dequantize_ref, so that a fault of the JAX path
    would show as such."""
    target_np = _dequant_target()
    target = tree_from_numpy(target_np, "cpu")
    q = quantize_tree(target)
    ref = dequantize_tree_reference(q, target, device="cpu")
    fast = dequantize_tree(q, target)
    q_np = tree_to_numpy(q)
    jax_ref = jax_dequantize_tree_reference(q_np, target_np)
    assert sorted(k for k in q if isinstance(q[k], dict)) == ["a", "b", "h"]
    for k, t in target.items():
        assert ref[k].dtype == t.dtype and ref[k].shape == t.shape, k
        assert torch.equal(ref[k], fast[k]), k
        got = tree_to_numpy(ref[k])
        np.testing.assert_array_equal(_bits(got), _bits(jax_ref[k]))
        if isinstance(q[k], dict):
            x = dequantize_ref(q_np[k]["q"], q_np[k]["s"]).reshape(-1)[: t.numel()]
            want = x.reshape(target_np[k].shape).astype(target_np[k].dtype)
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            np.testing.assert_array_equal(got, target_np[k])


def test_dequantize_tree_reference_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    target = tree_from_numpy(_dequant_target(), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dequantize_tree_reference(quantize_tree(target), target)
