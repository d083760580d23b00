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
