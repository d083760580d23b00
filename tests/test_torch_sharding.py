"""The port's partition rules and activation pins against the reference.

``param_spec_for``/``param_specs``, ``cache_spec_for``/``cache_specs``
and ``batch_specs`` equal ``repro.models.sharding``'s exactly, leaf by
leaf, for every arch on 1x1, 4x4, 16x16 and 2x16x16 meshes. The
reference's rules read only ``mesh.shape``, ``mesh.axis_names`` (and
``mesh.devices.size``), so they run here on a duck-typed mesh of any
shape, with no devices; the port's read the same shape as a mapping.
Then the layout itself: each rank's DTensor shard (offsets and shape
under ``to_placements``) equals the slice that
``NamedSharding.devices_indices_map`` gives each device of a 2x2x2
``("pod", "data", "model")`` mesh (a subprocess with 8 placeholder XLA
devices and an 8-rank fake process group; neither computes). Last the
activation pins: ``shard_act`` and ``tp_size`` with and without a mesh,
``pad_heads_for_tp`` under 16-way TP.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.models.sharding as RS
from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
import repro_torch.models.sharding as TS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.attention import attention, pad_heads_for_tp
from repro_torch.models import get_model
from repro_torch.utils.treelib import flatten_with_names

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "1x1": {"data": 1, "model": 1},
    "4x4": {"data": 4, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


class DuckMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


def ref_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def port_leaves(tree):
    return [(n, tuple(s)) for n, s in flatten_with_names(tree, is_leaf=TS.is_spec)[0]]


def assert_specs_equal(ref, port):
    r, p = ref_leaves(ref), port_leaves(port)
    assert len(r) == len(p)
    for a, (name, b) in zip(r, p):
        assert a == b, (name, a, b)


@pytest.fixture(scope="module")
def models():
    return {arch: (ref_get_model(ref_get_config(arch)), get_model(get_config(arch)))
            for arch in ARCHS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(models, arch, mesh):
    ref, port = models[arch]
    shape, duck = MESHES[mesh], DuckMesh(MESHES[mesh])
    assert_specs_equal(RS.param_specs(ref, duck), TS.param_specs(port, shape))
    assert_specs_equal(RS.batch_specs(ref, duck), TS.batch_specs(port, shape))
    assert_specs_equal(RS.cache_specs(ref, duck, 8, 64), TS.cache_specs(port, shape, 8, 64))
    # the per-leaf rules themselves, on the leaves' names and shapes
    for name, leaf in flatten_with_names(port.param_struct())[0]:
        want = RS.param_spec_for(name, tuple(leaf.shape), ref.cfg, duck)
        assert tuple(TS.param_spec_for(name, tuple(leaf.shape), port.cfg, shape)) == tuple(want)
    for name, leaf in flatten_with_names(port.cache_struct(8, 64))[0]:
        want = RS.cache_spec_for(name, tuple(leaf.shape), ref.cfg, duck)
        assert tuple(TS.cache_spec_for(name, tuple(leaf.shape), port.cfg, shape)) == tuple(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_rules_match_reference(mesh):
    shape, duck = MESHES[mesh], DuckMesh(MESHES[mesh])
    assert TS.fsdp_axes(shape) == RS.fsdp_axes(duck)
    for axes in (None, "model", ("data",), ("pod", "data") if "pod" in shape else ("data",)):
        assert TS.axis_size(shape, axes) == RS.axis_size(duck, axes)
        for dim in (1, 2, 6, 16, 32, 51865, 151936):
            got, want = TS._maybe(dim, axes, shape), RS._maybe(dim, axes, duck)
            assert tuple(TS.P(got)) == tuple(JP(want)), (dim, axes)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["2x16x16"]
    assert TS.to_placements(TS.P(), mesh) == (Replicate(),) * 3
    assert TS.to_placements(TS.P(None, ("pod", "data"), "model"), mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert TS.to_placements(TS.P("model", None), mesh) == (Replicate(), Replicate(), Shard(0))
    assert TS.P(("data",), None) == ("data", None)   # as PartitionSpec stores it
    with pytest.raises(ValueError, match="mesh order"):
        TS.to_placements(TS.P(("data", "pod")), mesh)


LAYOUT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
import torch
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.sharding import (
    activation_sharding, cache_specs, is_spec, param_specs, shard_act, to_placements)
from repro_torch.utils.treelib import flatten_with_names

shape3 = {"pod": 2, "data": 2, "model": 2}
model = get_model(get_config("qwen2-moe-a2.7b"))
leaves = dict(flatten_with_names(model.param_struct())[0])
specs = dict(flatten_with_names(param_specs(model, shape3), is_leaf=is_spec)[0])
cache = dict(flatten_with_names(model.cache_struct(8, 64))[0])
cspecs = dict(flatten_with_names(cache_specs(model, shape3, 8, 64), is_leaf=is_spec)[0])
cases = [(n, tuple(leaves[n].shape), specs[n]) for n in (
    "['embed']", "['layers']['wq']", "['layers']['wo']",
    "['layers']['moe']['w_gate']", "['layers']['moe']['w_down']")]
cases.append((".k", tuple(cache[".k"].shape), cspecs[".k"]))
jmesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
want = {n: NamedSharding(jmesh, JP(*sp)).devices_indices_map(shp) for n, shp, sp in cases}
for rank in range(8):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    for n, shp, sp in cases:
        local, off = compute_local_shape_and_global_offset(shp, mesh, to_placements(sp, mesh))
        sl = want[n][jax.devices()[rank]]
        ref = tuple((s.start or 0, d if s.stop is None else s.stop) for s, d in zip(sl, shp))
        got = tuple((o, o + l) for o, l in zip(off, local))
        assert got == ref, (n, rank, got, ref)
# shard_act on a DTensor activation (1x8 mesh; the pins need no data)
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
x = DTensor.from_local(torch.zeros(2, 4, 16), mesh, (Replicate(), Replicate()))
assert shard_act(x, "dp", None, "tp") is x                   # no mesh context
with activation_sharding(mesh):
    assert shard_act(x, "dp", None, "tp").placements == (Shard(0), Shard(2))
    # 12 features do not divide over 8: that dim stays replicated
    y = DTensor.from_local(torch.zeros(2, 4, 12), mesh, (Replicate(), Replicate()))
    assert shard_act(y, "dp", None, "tp").placements == (Shard(0), Replicate())
# tp_size and pad_heads_for_tp under a 1x16 DeviceMesh
from repro_torch.models.attention import pad_heads_for_tp
from repro_torch.models.sharding import tp_size
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (1, 16), mesh_dim_names=("data", "model"))
q = torch.zeros(1, 4, 12, 8)
with activation_sharding(mesh):
    assert tp_size() == 16
    assert pad_heads_for_tp(q, q, q)[0].shape == (1, 4, 16, 8)
print("layout ok")
"""


def test_shard_layout_matches_jax_devices_indices_map():
    """Every rank's shard offsets and shape of embed, a ``wq`` and a
    ``wo`` stack, two MoE expert stacks and a cache on a 2x2x2 mesh
    (identity device order) equal JAX's; this pins ``("pod", "data")``
    as pod-major. Then ``shard_act`` on DTensors under a 1x8 mesh, and
    ``tp_size``/``pad_heads_for_tp`` under a 1x16 one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", LAYOUT], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "layout ok" in out.stdout


def test_pins_are_identity_without_a_mesh():
    x = torch.randn(2, 3, 8)
    assert TS.tp_size() == 1
    assert TS.shard_act(x, "dp", None, "tp") is x
    q, k, v = torch.randn(1, 4, 12, 8), torch.randn(1, 4, 4, 8), torch.randn(1, 4, 4, 8)
    assert pad_heads_for_tp(q, k, v) == (q, k, v, 12)
    with TS.activation_sharding(MESHES["16x16"]):
        assert TS.tp_size() == 16
        assert TS.shard_act(x, "dp", None, "tp") is x   # plain tensors pass through
    assert TS.tp_size() == 1


@pytest.mark.parametrize("arch,heads", [("whisper-small", 12), ("recurrentgemma-2b", 10),
                                        ("qwen1.5-0.5b", 16)])
def test_pad_heads_for_tp(arch, heads):
    """Under 16-way TP whisper's 12 and recurrentgemma's 10 heads pad to
    16 and qwen's 16 stay; attention over the padded heads, sliced back,
    equals the unpadded attention bit for bit (each head's scores and
    products are their own)."""
    cfg = get_config(arch)
    assert cfg.n_heads == heads
    g = torch.Generator().manual_seed(0)
    b, s, hd = 2, 24, 16
    q = torch.randn(b, s, heads, hd, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, cfg.n_kv_heads, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, cfg.n_kv_heads, hd, generator=g).to(torch.bfloat16)
    with TS.activation_sharding({"data": 1, "model": 16}):
        qp, kp, vp, n_h = pad_heads_for_tp(q, k, v)
    assert n_h == heads
    assert qp.shape[2] == kp.shape[2] == vp.shape[2] == (16 if heads % 16 else heads)
    if heads % 16:
        assert not qp[:, :, heads:].any() and not kp[:, :, heads:].any()
    want = attention(q, k, v, causal=True, chunk_q=None)
    got = attention(qp, kp, vp, causal=True, chunk_q=None)[:, :, :n_h]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small", "xlstm-350m",
                                  "recurrentgemma-2b"])
def test_pins_change_no_bit_under_a_mesh_context(arch):
    """With ``activation_sharding`` on a 1x1 mesh shape every pin and
    ``pad_heads_for_tp`` is active and must leave the loss and its
    gradients as they are without it."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").state_tree()
    batch = {k: v for k, v in model.batch_struct(2, 16).items()}
    g = torch.Generator().manual_seed(1)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g) if k == "tokens"
                 else torch.randn(v.shape, generator=g).to(v.dtype)) for k, v in batch.items()}

    def loss_and_grads():
        loss, _ = model.loss(params, batch)
        return loss, torch.autograd.grad(loss, [p for _, p in flatten_with_names(params)[0]])

    l0, g0 = loss_and_grads()
    with TS.activation_sharding(MESHES["1x1"]):
        l1, g1 = loss_and_grads()
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
