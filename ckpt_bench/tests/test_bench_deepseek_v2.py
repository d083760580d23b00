"""The DeepSeek-V2 cell at smoke sizes: the benchmark's plain reference
against the program (float32 on the CPU), the cell run whole, traced
and not, its three per-layer readers, and the counts of
``counts_deepseek_v2`` at the cell's own sizes."""
import pytest
import torch
from conftest import SEED

from ckpt_bench import bench, check, counts_deepseek_v2, program_spans, trace
from ckpt_bench.inputs import make_batch, make_params
from ckpt_bench.reference import deepseek_v2 as ref
from ckpt_bench.reference.train import train_steps

CELL = "deepseek-v2-lite.train"
READERS = ("moe_step_mfu", "moe_expert_load_max")


def smoke_cell():
    """The cell with every width cut, float32 compute, the layer holding
    4 of the router's 16 experts (the second of 4 shares)."""
    cell = bench.load_cell(CELL)
    cell.cfg = dict(cell.cfg, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256,
                    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    compute_dtype="float32",
                    moe=dict(cell.cfg["moe"], n_experts=16, n_held=4, held_start=4, top_k=3,
                             expert_d_ff=24, shared_d_ff=48),
                    checkpoint=dict(cell.cfg["checkpoint"], chunk_size=64 * 1024, nodes=2,
                                    ppn=2))
    cell.traffic = dict(cell.traffic, global_batch=4, seq_len=40)
    return cell


def test_reference_matches_the_program():
    """Same parameters and batches: the same loss and AdamW steps. The
    query blocks of the reference's attention are cut to 16 so that the
    smoke sequence spans three of them."""
    c = smoke_cell()
    dev = torch.device("cpu")
    params = make_params(ref.param_specs(c.cfg), SEED, dev)
    batches = [make_batch(c.cfg, c.traffic, SEED, j, dev) for j in range(3)]
    got = bench.program_readings(c.cfg, params, batches, dev)
    was = ref.BLOCK_Q
    ref.BLOCK_Q = 16
    try:
        want = train_steps(ref, c.cfg, params, batches, c.cfg["optimizer"])
    finally:
        ref.BLOCK_Q = was
    numbers, details = check.step_numbers(got, want)
    assert numbers["loss_gap"] < 1e-6, details
    assert numbers["grad_gap"] < 1e-4, details
    assert numbers["grad_diff"] < 1e-4, details
    assert numbers["change_gap"] < 1e-4, details
    assert details["unmoved_leaves"] == []


def test_the_cell_runs_traced_and_not(monkeypatch):
    """The whole cell on the CPU (no device: the profiler's start and stop
    stand in for it). Traced, the counters fill the two readers that
    read them; the roofline finds no kernel here and gives nothing.
    Untraced, none of the three reads anything."""
    from torch.autograd import profiler

    monkeypatch.setattr(trace, "start", lambda: profiler._set_is_profiler_enabled(True))
    monkeypatch.setattr(trace, "stop", lambda prof: profiler._set_is_profiler_enabled(False)
                        or [])
    monkeypatch.setattr(program_spans, "_counts", type(program_spans._counts)(int))
    c = smoke_cell()
    keep = {}
    res = bench.run_cell(c, SEED, 1.0, traced=True, device="cpu", log=lambda *a, **k: None,
                         keep=keep)
    rec = keep["record"]
    assert res["correct"] is True, res["checks"]
    counts = program_spans.collect()[1]
    m = c.cfg["moe"]
    routed = len(rec.steps) * 4 * 40 * m["top_k"] * (c.cfg["n_layers"] - 1)
    assert counts["moe.routed_slots"] == routed
    assert 0 < counts["moe.held_max_slots"] <= counts["moe.held_slots"] < routed
    for name in READERS:
        v = bench.load_reader("metrics", name)(rec)
        assert v is not None and v > 0, name
        assert res["metrics"][name]["value"] == v
    assert res["metrics"]["moe_expert_load_max"]["value"] >= 1
    assert bench.load_reader("metrics", "moe_experts_roofline")(rec) is None

    keep = {}
    res = bench.run_cell(c, SEED, 0.5, device="cpu", log=lambda *a, **k: None, keep=keep)
    assert res["correct"] is True and "train_tokens_per_s" in res["metrics"]
    for name in READERS + ("moe_experts_roofline",):
        assert bench.load_reader("metrics", name)(keep["record"]) is None, name


def test_counts_at_the_cells_sizes():
    """At 8 x 4,096 with each held expert at its mean load (3,072 slots a
    layer): latent attention (projections and causal scores) is 39 % of
    the model FLOPs and the MoE layers (router, shared and held experts)
    31 %; the grouped products run four times the forward's expert
    products."""
    cfg = bench.load_cell(CELL).cfg
    d, m = cfg["d_model"], cfg["moe"]
    n_moe = cfg["n_layers"] - cfg["first_k_dense_replace"]
    held = 8 * 4096 * m["top_k"] * m["n_held"] / m["n_experts"] * n_moe
    assert held / n_moe / m["n_held"] == 3072
    total = counts_deepseek_v2.train_flops(cfg, 8, 4096, held)
    no_attn = dict(cfg, n_heads=0, kv_lora_rank=0, qk_rope_head_dim=0)
    mla = total - counts_deepseek_v2.train_flops(no_attn, 8, 4096, held)
    moe = 6 * (8 * 4096 * n_moe * (d * m["n_experts"] + 3 * d * m["shared_d_ff"])
               + counts_deepseek_v2.expert_macs(cfg, held))
    assert mla / total == pytest.approx(0.39, abs=0.01)
    assert moe / total == pytest.approx(0.31, abs=0.01)
    assert counts_deepseek_v2.grouped_mm_flops(cfg, held) == 8 * counts_deepseek_v2.expert_macs(
        cfg, held)
