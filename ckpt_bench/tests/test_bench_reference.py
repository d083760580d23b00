"""The plain references against the program: the same parameters and
batches give the same loss and the same AdamW steps (float32 on the CPU
at smoke sizes)."""
import importlib

import pytest
import torch
from conftest import SEED, smoke_cell

from ckpt_bench import bench, check
from ckpt_bench.inputs import make_batch, make_params
from ckpt_bench.reference.train import train_steps


@pytest.mark.parametrize("cell", ["whisper-small.train", "xlstm-350m.resume"])
def test_reference_matches_the_program(cell):
    c = smoke_cell(cell)
    ref = importlib.import_module(f"ckpt_bench.reference.{c.cfg['reference']}")
    dev = torch.device("cpu")
    params = make_params(ref.param_specs(c.cfg), SEED, dev)
    batches = [make_batch(c.cfg, c.traffic, SEED, j, dev) for j in range(3)]
    got = bench.program_readings(c.cfg, params, batches, dev)
    want = train_steps(ref, c.cfg, params, batches, c.cfg["optimizer"])
    numbers, details = check.step_numbers(got, want)
    assert numbers["loss_gap"] < 1e-6, details
    assert numbers["grad_gap"] < 1e-4, details
    assert numbers["grad_diff"] < 1e-4, details
    assert numbers["change_gap"] < 1e-4, details
    assert details["unmoved_leaves"] == []


@pytest.mark.parametrize("cell", ["whisper-small.train", "xlstm-350m.resume"])
def test_inputs_follow_the_seed(cell):
    c = smoke_cell(cell)
    ref = importlib.import_module(f"ckpt_bench.reference.{c.cfg['reference']}")
    specs = ref.param_specs(c.cfg)
    a, b = (make_params(specs, SEED, "cpu") for _ in range(2))
    other = make_params(specs, SEED + 1, "cpu")
    from ckpt_bench.tree import flatten

    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(a), flatten(b)))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(flatten(a), flatten(other)))
    b0, b1 = (make_batch(c.cfg, c.traffic, SEED, j, "cpu") for j in (0, 1))
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert int(b0["tokens"].max()) < c.cfg["vocab_size"]
