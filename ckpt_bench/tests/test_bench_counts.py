"""The FLOP and byte counts against counts by hand and by PyTorch's
FLOP counter, and the trace's reduction on made-up events."""
import torch
from conftest import SEED, smoke_cell
from torch.utils.flop_counter import FlopCounterMode

from ckpt_bench import counts, trace
from ckpt_bench.inputs import make_batch, make_params
from ckpt_bench.reference import whisper


def test_whisper_forward_count_equals_the_products_the_reference_runs():
    """Every product of the reference's forward, as PyTorch counts them
    (the decoder's whole square of self-attention scores, masked or not)."""
    c = smoke_cell("whisper-small.train")
    params = make_params(whisper.param_specs(c.cfg), SEED, "cpu")
    batch = make_batch(c.cfg, c.traffic, SEED, 0, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        whisper.loss(params, c.cfg, batch)
    b, s = c.traffic["global_batch"], c.traffic["seq_len"]
    assert fc.get_total_flops() == 2 * counts.whisper_forward_macs(c.cfg, b, s, causal_half=False)


def test_whisper_small_train_step_by_hand():
    """16 x (1,500 frames + 448 tokens) at 2 + 2 layers: forward
    multiply-adds, layer by layer."""
    cfg = dict(d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
               enc_seq=1500, n_enc_layers=2, n_layers=2, family="audio")
    d, ff, t, v = 768, 3072, 1500, 51865
    enc = 16 * t * (4 * d * d + 2 * d * ff + 2 * t * d) * 2
    dec = 16 * 448 * (6 * d * d + 2 * d * ff + 2 * (449 / 2) * d + 2 * t * d) * 2
    cross_kv = 16 * t * 2 * d * d * 2
    head = 16 * 448 * d * v
    assert counts.whisper_forward_macs(cfg, 16, 448) == enc + dec + cross_kv + head
    assert counts.train_flops(cfg, 16, 448) == 6 * (enc + dec + cross_kv + head)
    assert counts.train_flops(dict(cfg, family="ssm"), 16, 448) is None


def test_fused_precodec_bytes_by_hand():
    # 1,000 words in chunks of 256: 4 chunks; read 2 x 4,000 bytes, write 4,000 + 4 x 12
    assert counts.fused_precodec_bytes(1000, 256) == 12 * 1000 + 12 * 4
    assert counts.fused_precodec_bytes(1024, 256) == 12 * 1024 + 12 * 4


def test_trace_reduce_busy_and_idle_by_host_span():
    spans = trace.Spans()
    spans.add("step", 100, 200)
    spans.add("save", 200, 400)
    events = [(110, 150, "gemm"), (140, 190, "gemm"), (250, 260, "copy"), (50, 105, "early")]
    t = trace.reduce(events, spans, 100, 500)
    assert t.window_s == 400e-9
    # busy: 100-105 (clipped to the window), 110-190 (two kernels overlapping), 250-260
    assert abs(t.busy_s - 95e-9) < 1e-15
    assert t.op_s == {"gemm": 90e-9, "copy": 10e-9, "early": 5e-9}
    # idle: 105-110 and 190-200 in step, 200-250 and 260-400 in save, 400-500 in no span
    assert abs(t.idle_s["step"] - 15e-9) < 1e-15
    assert abs(t.idle_s["save"] - 190e-9) < 1e-15
    assert abs(t.idle_s["other"] - 100e-9) < 1e-15
    assert trace.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]
