"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's.

``analytic_hbm_bytes`` equals ``repro.launch.dryrun``'s float exactly
for every arch x shape on both production meshes (the reference reads
only the mesh's shape, so it runs on a duck-typed mesh). The cells run
in one subprocess on a 4x4 mesh over a 16-rank fake process group (the
port's twin of ``tests/test_dryrun.py``): each record's
``argument_bytes`` equals the per-device shard bytes of the reference's
own input structs under the reference's own specs, and train cells
count ``flops_global / model_flops`` in a stated band.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.models.sharding as RS
from repro.configs import ARCHS, SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_train_state as ref_init_train_state
from repro.train.train_step import batch_spec_tree as ref_batch_spec_tree
from repro.train.train_step import train_state_specs as ref_train_state_specs
import repro_torch.launch.dryrun as DR
from repro_torch.configs import get_config
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("tinyllama-1.1b", "decode_32k"), ("tinyllama-1.1b", "train_4k"),
         ("qwen2-moe-a2.7b", "train_4k"), ("whisper-small", "train_4k")]
MESH = {"data": 4, "model": 4}


class DuckMesh:
    """What the reference's rules and ``analytic_hbm_bytes`` read of a
    ``jax.sharding.Mesh``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()), dtype=object)


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``: importing it sets ``XLA_FLAGS`` for 512
    placeholder devices, so this process's backend is made first and the
    variable is put back after (subprocesses must not inherit it)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_matches_reference(ref_dryrun, arch, multi_pod):
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    ref_model, model = ref_get_model(ref_get_config(arch)), get_model(get_config(arch))
    knobs = DR.KNOBS.get(arch, DR.DEFAULT_KNOBS)
    assert knobs == ref_dryrun.KNOBS.get(arch, ref_dryrun.DEFAULT_KNOBS)
    for cell in SHAPES.values():
        want = ref_dryrun.analytic_hbm_bytes(ref_model, cell, DuckMesh(shape), knobs)
        got = DR.analytic_hbm_bytes(model, cell, shape, knobs)
        assert got == want, (cell.name, got, want)


RUN_CELLS = r"""
import json, sys
from pathlib import Path
import repro_torch.launch.dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
out = {"production": {}}
for multi_pod, world in ((False, 256), (True, 512)):
    DR.fake_process_group(world)
    mesh = make_production_mesh(multi_pod=multi_pod)
    out["production"][str(multi_pod)] = [list(mesh.mesh_dim_names), list(mesh.shape)]
DR.fake_process_group(16)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
for arch, shape in json.loads(sys.argv[2]):
    out[arch + "/" + shape] = DR.run_cell(arch, shape, multi_pod=False, force=True,
                                          mesh=mesh, report_dir=Path(sys.argv[1]))
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", RUN_CELLS, str(tmp_path_factory.mktemp("dryrun")),
         json.dumps(CELLS)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_meshes(records):
    assert records["production"] == {
        "False": [["data", "model"], [16, 16]],
        "True": [["pod", "data", "model"], [2, 16, 16]],
    }


def test_dryrun_cell_small_mesh(records):
    """The twin of ``tests/test_dryrun.py``: tinyllama's decode_32k on a
    4x4 mesh."""
    rec = records["tinyllama-1.1b/decode_32k"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == 16
    assert rec["roofline"]["flops_per_dev"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None


def _ref_shard_bytes(struct, specs, mesh):
    """Per-device bytes of ``struct``'s leaves under the reference's
    ``specs`` (every sharded dim divides: the rules guard it)."""
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(struct),
                          jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))):
        dims = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            n = RS.axis_size(mesh, entry)
            assert dims[d] % n == 0
            dims[d] //= n
        total += math.prod(dims) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_match_reference(records, ref_dryrun, arch, shape):
    rec = records[f"{arch}/{shape}"]
    assert rec["status"] == "ok", rec.get("error")
    model, mesh, cell = ref_get_model(ref_get_config(arch)), DuckMesh(MESH), SHAPES[shape]
    knobs = ref_dryrun.KNOBS.get(arch, ref_dryrun.DEFAULT_KNOBS)
    if cell.kind == "train":
        tcfg = RefTrainConfig(opt=RefOptConfig(state_dtype=knobs["opt_dtype"]),
                              microbatches=knobs["microbatches"], accum_dtype=knobs["accum"])
        state = jax.eval_shape(lambda: ref_init_train_state(model, jax.random.PRNGKey(0), tcfg))
        batch = model.batch_struct(cell.global_batch, cell.seq_len)
        want = (_ref_shard_bytes(state, ref_train_state_specs(model, mesh, tcfg), mesh)
                + _ref_shard_bytes(batch, ref_batch_spec_tree(model, mesh, batch), mesh))
    else:
        assert cell.kind == "decode"
        tok = jax.ShapeDtypeStruct((cell.global_batch, 1), jnp.int32)
        tok_spec = JP(RS._maybe(cell.global_batch, RS.fsdp_axes(mesh), mesh), None)
        want = (_ref_shard_bytes(model.param_struct(), RS.param_specs(model, mesh), mesh)
                + _ref_shard_bytes(model.cache_struct(cell.global_batch, cell.seq_len),
                                   RS.cache_specs(model, mesh, cell.global_batch,
                                                  cell.seq_len), mesh)
                + _ref_shard_bytes(tok, tok_spec, mesh))
    assert rec["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b", "whisper-small"])
def test_train_flops_over_model_flops(records, arch):
    """``flops_global / model_flops`` of a train cell lies in [1.25, 1.75]
    (measured on this 4x4 mesh: tinyllama-1.1b 1.604, qwen2-moe-a2.7b
    1.444, whisper-small 1.497). Remat recomputes every layer's forward
    in backward, so the layers' matmuls count 8/6 of their 6·N·D; the
    attention scores, which 6·N·D leaves out, add to that (most at 4k
    tokens with a narrow model), and so does an MoE layer's capacity
    slack (its experts run over buffers of 1.25x the routed tokens); the
    embedding table, which N counts but no matmul reads, takes away."""
    rec = records[f"{arch}/train_4k"]
    assert rec["status"] == "ok", rec.get("error")
    ratio = rec["flops_global"] / rec["roofline"]["model_flops_global"]
    assert 1.25 <= ratio <= 1.75, ratio
    assert rec["roofline"]["flops_per_dev"] == rec["flops_global"] / MESH["data"]
