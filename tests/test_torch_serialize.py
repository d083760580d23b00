"""Streams, leaf tables, rank blobs and manifests of the port's encoder
are byte-identical to the JAX package's, for every codec and framing,
on a state holding f32, bf16, bool and int32 leaves."""
import os
from dataclasses import astuple

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.serialize as RS
import repro.core.serialize_ref as RSR
import repro_torch.core.serialize as TS
import repro_torch.core.serialize_ref as TSR
from repro.core.cluster import theta_like as r_theta
from repro_torch.core.cluster import theta_like as t_theta
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy


def numpy_state(step):
    rng = np.random.default_rng(100 + step)
    return {
        "params": {
            "w": (rng.standard_normal((96, 300)) + step).astype(np.float32),
            "h": np.asarray(jnp.asarray(rng.standard_normal((40, 130)), jnp.bfloat16)),
            "b": np.full((37,), 0.5 * step, np.float32),
        },
        "mask": rng.random(513) < 0.5,
        "ids": rng.integers(-1000, 1000, (7, 11)).astype(np.int32),
        "step": np.array(step, np.int32),
    }


def _rows(leaves):
    """Leaf table rows; the two packages' LeafEntry classes never compare equal."""
    return [astuple(l) for l in leaves]


def _encode_both(codec, chunk_size, chunk_aligned):
    """Encode steps 1 and 2 (2 a small update of 1) in both packages."""
    out = []
    for pkg, theta, conv in (
        (RS, r_theta, lambda s: s),
        (TS, t_theta, lambda s: tree_from_numpy(s, "cpu")),
    ):
        cluster = theta(2, 3)
        s1 = numpy_state(1)
        s2 = dict(s1, step=np.array(2, np.int32))
        s2["params"] = dict(s1["params"], b=s1["params"]["b"] + 1)
        e1 = pkg.encode_state(1, conv(s1), cluster, codec=codec,
                              chunk_size=chunk_size, chunk_aligned=chunk_aligned)
        e2 = pkg.encode_state(2, conv(s2), cluster, codec=codec, base=e1,
                              chunk_size=chunk_size, chunk_aligned=chunk_aligned)
        out.append((e1, e2))
    return out


@pytest.mark.parametrize("codec", ["none", "zstd", "zstd+delta"])
@pytest.mark.parametrize(
    "chunk_size,chunk_aligned",
    [(0, False), (4096, False), (4096, True), (1 << 20, False), (1 << 20, True)],
)
def test_encoded_state_matches(codec, chunk_size, chunk_aligned):
    ref, got = _encode_both(codec, chunk_size, chunk_aligned)
    for r, t in zip(ref, got):
        assert bytes(r.stream) == bytes(t.stream)
        assert _rows(r.manifest.leaves) == _rows(t.manifest.leaves)
        assert r.manifest.to_json() == t.manifest.to_json()
        assert [bytes(b) for b in r.blobs] == [bytes(b) for b in t.blobs]
    if codec == "zstd+delta":
        assert got[1].manifest.base_step == 1


def test_serialize_reference_matches_fast_path():
    state = tree_from_numpy(numpy_state(3), "cpu")
    stream, leaves = TS.serialize_tree(state)
    ref_stream, ref_leaves = TSR.serialize_tree_reference(state)
    assert bytes(stream) == ref_stream and leaves == ref_leaves
    jstream, jleaves = RSR.serialize_tree_reference(numpy_state(3))
    assert ref_stream == jstream and _rows(ref_leaves) == _rows(jleaves)


def test_bf16_leaf_entry_and_decode():
    state = tree_from_numpy(numpy_state(4), "cpu")
    stream, leaves = TS.serialize_tree(state)
    entry = next(l for l in leaves if l.name == "['params']['h']")
    assert entry.dtype == "bfloat16" and entry.shape == (40, 130)
    back = TS.deserialize_tree(stream, leaves, state)
    assert back["params"]["h"].dtype == torch.bfloat16
    for a, b in zip(
        TS.flatten_with_names(tree_to_numpy(back))[0],
        TS.flatten_with_names(numpy_state(4))[0],
    ):
        assert a[1].dtype == b[1].dtype and a[1].tobytes() == b[1].tobytes()


def test_decode_state_of_reference_checkpoint():
    """A stream the JAX package encoded decodes in the port."""
    cluster = r_theta(2, 2)
    enc = RS.encode_state(5, numpy_state(5), cluster, codec="zstd", chunk_size=4096)
    target = tree_from_numpy(numpy_state(0), "cpu")
    back = TS.decode_state(TS.Manifest.from_json(enc.manifest.to_json()),
                           enc.blobs, target)
    want = numpy_state(5)
    got = tree_to_numpy(back)
    for (n, a), (_, b) in zip(TS.flatten_with_names(got)[0],
                              TS.flatten_with_names(want)[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


def test_deserialize_rejects_wrong_names():
    state = tree_from_numpy(numpy_state(1), "cpu")
    stream, leaves = TS.serialize_tree(state)
    with pytest.raises(ValueError):
        TS.deserialize_tree(stream, leaves, {"other": state["params"], "x": 1,
                                             "y": 2, "z": 3})


# -- decode into a destination the caller owns, leaves as views ---------------


def view_state(step):
    """f32, bf16, int32 and uint8 leaves; the last f32 leaf starts 3 bytes
    past a word boundary, so it cannot be a float32 view of the stream."""
    g = torch.Generator().manual_seed(step)
    return {
        "a_f32": torch.randn(96, 300, generator=g) + step,
        "b_bf16": torch.randn(40, 130, generator=g).to(torch.bfloat16),
        "c_i32": torch.randint(-1000, 1000, (7, 12), generator=g, dtype=torch.int32),
        "d_u8": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8),
        "e_f32": torch.full((37,), 0.5 * step),
    }


def _as_bytes(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("codec,step,impl", [
    ("none", 1, ""), ("zstd+delta", 1, "zstd"), ("zstd+delta", 2, "zstd"),
    ("zstd+delta", 1, "zlib"), ("zstd+delta", 2, "zlib"),
], ids=["none", "zstd-anchor", "zstd-delta", "zlib-anchor", "zlib-delta"])
def test_decode_into_a_destination_gives_views_of_it(monkeypatch, codec, step, impl):
    if impl == "zlib":   # the backend where zstandard does not import
        monkeypatch.setattr(TS, "_zstd", None)
    cluster = t_theta(2, 3)
    s1 = view_state(1)
    s2 = dict(s1, e_f32=s1["e_f32"] + 1)
    e1 = TS.encode_state(1, s1, cluster, codec=codec, chunk_size=4096)
    e2 = TS.encode_state(2, s2, cluster, codec=codec, base=e1, chunk_size=4096)
    enc, base = (e1, None) if step == 1 else (e2, e1.stream)
    man = enc.manifest
    assert man.codec_impl == impl
    if step == 2:
        assert man.base_step == 1
    entry = {l.name: l for l in man.leaves}
    assert entry["['e_f32']"].offset % 4 == 3
    target = view_state(0)

    want = TS.decode_state(man, enc.blobs, target, base_stream=base)
    into = torch.empty(man.total_raw_bytes, dtype=torch.uint8)
    got = TS.decode_state(man, enc.blobs, target, base_stream=base, into=into)

    lo, hi = into.data_ptr(), into.data_ptr() + into.nbytes
    assert bytes(into.numpy()) == bytes(enc.stream)
    saved = (s1, s2)[step - 1]
    for name in saved:
        g, w = got[name], want[name]
        assert g.dtype == w.dtype == saved[name].dtype and g.shape == w.shape
        assert torch.equal(_as_bytes(g), _as_bytes(w)), name
        assert torch.equal(_as_bytes(g), _as_bytes(saved[name])), name
        # the default call: each leaf a copy that owns its storage
        assert w.untyped_storage().nbytes() == w.nbytes, name
        if name == "e_f32":   # misaligned: a copy of its own
            assert g.untyped_storage().data_ptr() != lo
            assert g.untyped_storage().nbytes() == g.nbytes
        else:
            assert g.untyped_storage().data_ptr() == lo, name
            assert lo <= g.data_ptr() and g.data_ptr() + g.nbytes <= hi, name
            assert g.data_ptr() == lo + entry[f"['{name}']"].offset, name


def test_decode_destination_must_fit_the_stream():
    enc = TS.encode_state(1, view_state(1), t_theta(2, 2), codec="zstd", chunk_size=4096)
    n = enc.manifest.total_raw_bytes
    for bad in (np.empty(n - 1, np.uint8), np.empty(n, np.int8),
                np.empty(2 * n, np.uint8)[::2]):
        with pytest.raises(ValueError):
            TS.decode_stream(enc.manifest, enc.blobs, out=bad)
    out = np.zeros(n, np.uint8)
    got = TS.decode_stream(enc.manifest, enc.blobs, out=out)
    assert np.shares_memory(np.asarray(got), out) and bytes(out) == bytes(enc.stream)
