"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``. Tokens route per sequence with
capacity ``ceil(S * top_k * capacity_factor / n_experts)`` (at least 4,
at most S); a (token, k) slot past its expert's capacity drops. The
reference's ``shard_act`` pins (expert parallelism over "model") sit
where it has them; they are no-ops without a mesh.

:func:`route` is the reference's routing on given router logits, bit
for bit: top-k takes the lower expert index first on ties (as
``jax.lax.top_k``; ``torch.topk`` promises no order), and each slot's
queue position is a cumsum over the ``(S * K)`` slots of its sequence in
(s, k) order.

Dispatch writes each kept slot into ``(B, E, C + 1, d)`` at its own
(expert, position) and every dropped slot into the scratch position C,
which is then sliced off. Kept positions are unique, so no slot is the
sum of two writes and the buffer is the reference's (whose scatter-add
adds a zero for each dropped slot at C - 1) under deterministic
algorithms on any device. Combine gathers ``h[b, sel, pos]`` at the
clipped position and weights it by ``gates * keep``.

:func:`moe_ffn_dropless` is DeepSeek's layer (``MoEConfig.dropless``):
softmax over every expert of the router (float32), greedy top-k on the
probabilities with the lower index first on ties, the selected
probabilities as weights (DeepSeek-V2-Lite neither renormalises nor
scales them), and no capacity. The layer holds the
experts ``held_start .. held_start + n_held - 1`` of the router's
``n_experts`` (expert parallelism: the other shares live on other
devices, and on one device the exchange is absent) and computes only
their part of ``sum_k w_k E_k(x)``: slots routed elsewhere add nothing.
Held slots are sorted by expert (stable, so in token order within an
expert), their rows gathered, and the three products run as grouped
matrix products over the held experts (``torch._grouped_mm``) on the
exact slot counts, which the host learns once a layer. The weighted rows
are added back to their tokens in float32 (``index_add_``: deterministic
under ``deterministic_algorithms()``). The shared experts and the aux
loss (over all ``n_experts``, so every share computes the same) are
computed once. The layer also returns its routing counts, on the device:
all slots, the held slots, and the busiest held expert's slots.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.sharding import shard_act


def capacity(moe: MoEConfig, seq: int) -> int:
    c = int(-(-seq * moe.top_k * moe.capacity_factor // moe.n_experts))
    return max(4, min(c, seq))


def route(
    router_logits: torch.Tensor, moe: MoEConfig, c: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits: (B, S, E) float32 -> ``(sel, pos_sel, keep, gates,
    probs)``: the chosen experts (B, S, K) int64, each slot's position in
    its expert's queue clipped to ``c - 1``, whether the slot is within
    capacity, the gates (softmax over the top-k logits) and the router
    probabilities (B, S, E)."""
    b, s, e = router_logits.shape
    k = moe.top_k
    probs = torch.softmax(router_logits, dim=-1)
    top_v, sel = torch.sort(router_logits, dim=-1, descending=True, stable=True)
    top_v, sel = top_v[..., :k], sel[..., :k]
    gates = torch.softmax(top_v, dim=-1)
    onehot = F.one_hot(sel, e).reshape(b, s * k, e)             # (B, S*K, E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_sel = (pos * onehot).sum(-1).reshape(b, s, k)
    keep = pos_sel < c
    return sel, pos_sel.clamp(0, c - 1), keep, gates, probs


def moe_ffn(
    x: torch.Tensor, params: Dict[str, torch.Tensor], moe: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balancing loss () float32)."""
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    c = capacity(moe, s)

    router_logits = x.float() @ params["router"].float()        # (B, S, E)
    sel, pos_sel, keep, gates, probs = route(router_logits, moe, c)

    # ---- dispatch: kept slots to their unique (expert, position), dropped
    # slots to the scratch position c
    rows = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    slot = torch.where(keep, pos_sel, c)
    buf = x.new_zeros((b, e, c + 1, d))
    buf[rows, sel, slot] = x[:, :, None, :].expand(b, s, k, d)
    buf = shard_act(buf[:, :, :c], "dp", "tp", None, None)     # expert parallelism
    h = shard_act(swiglu_experts(buf, params), "dp", "tp", None, None)   # (B, E, C, d)

    # ---- combine: gather back + gate-weighted sum over k
    w = (gates * keep).to(x.dtype)                              # dropped -> 0
    out = torch.einsum("bskd,bsk->bsd", h[rows, sel, pos_sel], w)

    # ---- shared experts (always on)
    if "shared_gate" in params:
        out = out + swiglu(x, params["shared_gate"], params["shared_up"], params["shared_down"])

    # ---- auxiliary load-balancing loss (Switch-style)
    counts = F.one_hot(sel, e).float().sum(dim=2)                # (B, S, E)
    density = counts.reshape(b * s, e).mean(dim=0)              # sums to k
    prob_mean = probs.reshape(b * s, e).mean(dim=0)
    aux = e * torch.sum(density / k * prob_mean) * moe.router_aux_weight
    return out, aux


def swiglu_experts(buf: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """buf: (B, E, C, d); expert weights (E, d, ff) / (E, ff, d)."""
    dt = buf.dtype
    g = shard_act(torch.einsum("becd,edf->becf", buf, params["w_gate"].to(dt)),
                  "dp", "tp", None, None)
    u = shard_act(torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt)),
                  "dp", "tp", None, None)
    h = F.silu(g.float()).to(dt) * u
    return torch.einsum("becf,efd->becd", h, params["w_down"].to(dt))


def seq_aux_loss(probs: torch.Tensor, sel: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """DeepSeek's sequence-wise balance loss: per sequence, each expert's
    share of the slots over its fair share times its mean probability,
    summed over the experts; the mean over the sequences, times the
    weight. probs (B, S, E), sel (B, S, K)."""
    b, s, e = probs.shape
    k = sel.shape[-1]
    load = F.one_hot(sel.reshape(b, s * k), e).sum(1).float() / (s * k / e)   # (B, E)
    return (load * probs.mean(dim=1)).sum(dim=1).mean() * moe.router_aux_weight


def grouped_swiglu(rows: torch.Tensor, offs: torch.Tensor,
                   params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """SwiGLU of each held expert on its rows: ``rows`` (N, d) sorted by
    expert, ``offs`` (E_held,) int32 the end of each expert's rows."""
    dt = rows.dtype
    g = torch._grouped_mm(rows, params["w_gate"].to(dt), offs=offs)
    u = torch._grouped_mm(rows, params["w_up"].to(dt), offs=offs)
    h = F.silu(g.float()).to(dt) * u
    return torch._grouped_mm(h, params["w_down"].to(dt), offs=offs)


def moe_ffn_dropless(
    x: torch.Tensor, params: Dict[str, torch.Tensor], moe: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss () float32, counts (3,)
    int64: routed slots, held slots, the busiest held expert's slots)."""
    b, s, d = x.shape
    k, held, lo = moe.top_k, moe.held, moe.held_start
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)   # (B, S, E)
    # greedy top-k, the lower index first on ties
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[..., :k], sel[..., :k]
    aux = seq_aux_loss(probs, sel, moe)

    # held slots, sorted by expert (stable: token order within an expert)
    local = (sel - lo).reshape(-1)                                      # (B*S*K,)
    is_held = (local >= 0) & (local < held)
    key = torch.where(is_held, local, held)
    order = torch.sort(key, stable=True)[1]
    per_expert = torch.bincount(key, minlength=held + 1)[:held]
    n = int(per_expert.sum())          # the host learns the rows once a layer
    order = order[:n]
    token = order // k
    flat = x.reshape(b * s, d)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    if n:
        offs = torch.cumsum(per_expert, 0).to(torch.int32)
        y = grouped_swiglu(flat.index_select(0, token), offs, params)
        y = y.float() * w.reshape(-1).index_select(0, order)[:, None]
        out = out.index_add(0, token, y)
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared_gate" in params:
        out = out + swiglu(x, params["shared_gate"], params["shared_up"], params["shared_down"])
    counts = torch.stack([torch.full_like(per_expert[0], b * s * k), per_expert.sum(),
                          per_expert.max()])
    return out, aux, counts

