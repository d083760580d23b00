"""The controls, put in the program's place, come out as not correct
under each cell's limits: the reference with float8 matrix products, one
step below the bfloat16 products that the configurations state, and the
program on its own path with its parameters and optimizer state in
bfloat16, one step below the float32 that they state. On the CPU at
smoke sizes; the ``gpu`` test reads them at the cells' own sizes on
three seeds (``ckpt_bench/readings.py`` reads more: PERF.md)."""
import importlib

import pytest
import torch
from conftest import SEED, smoke_cell

from ckpt_bench import bench, check
from ckpt_bench.inputs import make_batch, make_params
from ckpt_bench.reference.train import train_steps

CELLS = ["whisper-small.save", "xlstm-350m.resume", "whisper-small.train"]
CONTROLS = ["fp8", "bf16_params"]


def readings(cell, control, seed, device):
    cfg, traffic = cell.cfg, cell.traffic
    ref = importlib.import_module(f"ckpt_bench.reference.{cfg['reference']}")
    params = make_params(ref.param_specs(cfg), seed, device)
    batches = [make_batch(cfg, traffic, seed, j, device) for j in range(3)]
    want = train_steps(ref, cfg, params, batches, cfg["optimizer"])
    if control == "fp8":
        got = train_steps(ref, cfg, params, batches, cfg["optimizer"], precision="fp8")
    else:
        got = bench.program_readings(dict(cfg, param_dtype="bfloat16"), params, batches, device)
    return check.step_numbers(got, want)[0]


def refused(cell, numbers):
    limits = {k: v for k, v in cell.limits.items() if k in numbers}
    return not check.judge(numbers, limits)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", CONTROLS)
def test_control_is_not_correct(name, control):
    cell = smoke_cell(name)
    assert refused(cell, readings(cell, control, SEED, torch.device("cpu")))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", CONTROLS)
def test_control_is_not_correct_at_the_cells_size(cuda_device, name, control):
    cell = bench.load_cell(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        assert refused(cell, readings(cell, control, seed, cuda_device))
