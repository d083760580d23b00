"""Operations of a DeepSeek-V2 training step, from shapes and the
program's routing counters, at the peaks of :mod:`ckpt_bench.counts`.

Two operations per multiply-add of every matrix product the model
needs, times three for forward and backward; remat's recompute is not
counted. From shapes, every token through: latent attention's four
projections and its causal scores and values (a query attends to itself
and the tokens before it, half of the square on average, over the query
and key head dims and the value head dim), the leading dense layers'
SwiGLU, each MoE layer's router and shared experts, and the head. The
routed experts' products depend on the routing: each slot of a held
expert (the counter ``moe.held_slots``) goes through three products of
``d_model x expert_d_ff``.

``grouped_mm_flops`` is what the grouped products run, for the roofline
of their kernel: the three products of each held slot in the forward
pass, again in remat's recompute, and twice in backward (the input's
gradient and the weights').
"""
from __future__ import annotations

from typing import Any, Dict

HELD_SLOTS = "moe.held_slots"
HELD_MAX_SLOTS = "moe.held_max_slots"


def shape_macs(cfg: Dict[str, Any], batch: int, seq: int) -> float:
    """Multiply-adds of one forward pass, but the routed experts'."""
    d, h, m = cfg["d_model"], cfg["n_heads"], cfg["moe"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    keys = (seq + 1) / 2
    attn = (d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) + h * vd * d
            + h * keys * (nope + rope + vd))
    dense = 3 * d * cfg["d_ff"]
    moe = d * m["n_experts"] + 3 * d * m["shared_d_ff"]
    k = cfg["first_k_dense_replace"]
    per_token = (cfg["n_layers"] * attn + k * dense + (cfg["n_layers"] - k) * moe
                 + d * cfg["vocab_size"])
    return batch * seq * per_token


def expert_macs(cfg: Dict[str, Any], held_slots: float) -> float:
    return held_slots * 3 * cfg["d_model"] * cfg["moe"]["expert_d_ff"]


def train_flops(cfg: Dict[str, Any], batch: int, seq: int, held_slots: float) -> float:
    """One step's model FLOPs, ``held_slots`` being the step's."""
    return 3 * 2 * (shape_macs(cfg, batch, seq) + expert_macs(cfg, held_slots))


def grouped_mm_flops(cfg: Dict[str, Any], held_slots: float) -> float:
    return 4 * 2 * expert_macs(cfg, held_slots)
