"""DeepSeek-V2's decoder (arXiv:2405.04434), plain PyTorch, float32.

The model as the configuration runs it: pre-RMSNorm blocks; multi-head
latent attention without query compression (``q = x W_q`` split per head
into a no-rope and a rope part; ``[c, k_pe] = x W_dkv``; ``[k_nope, v] =
rms_norm(c) W_ukv``; the rope part of the key one head shared by every
head; YaRN's rope frequencies with DeepSeek's de-interleave before the
half rotation; causal softmax at ``(nope + rope) ** -0.5`` times YaRN's
``mscale ** 2``); ``first_k_dense_replace`` leading layers with a dense
SwiGLU, then MoE layers: a float32 softmax router over every expert,
greedy top-k on the probabilities (the lower index first on ties), the
selected probabilities as weights (``norm_topk_prob`` false and
``routed_scaling_factor`` 1 in DeepSeek-V2-Lite's config), the shared
experts as one SwiGLU, and DeepSeek's sequence-wise balance loss; an
untied head.

Departures from the published model, shared with the program under
test: random weights (``param_specs``); the vocabulary is the slice the
configuration gives (the loss is over the slice); a layer holds the
experts ``held_start .. held_start + n_held - 1`` of the router's
``n_experts`` and adds only their part of the routed sum, as one device
of an expert-parallel deployment does (what the other shares add is left
out here and in the program alike); the loss is the next-token loss plus
the layers' balance losses (the published code adds the balance loss's
gradient without adding it to the reported loss); the rope part of
queries and keys stays in the de-interleaved order (the scores do not
change). Every held expert runs on every token, weighted by its gate
(zero where the token did not choose it): the same sum as a dispatch,
computed another way. Each layer is recomputed in backward
(``torch.utils.checkpoint``) and attends in blocks of queries, so that
the full batch fits on one card; the numbers do not change.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ckpt_bench.reference.ops import mm, next_token_loss, rms_norm

BLOCK_Q = 1024


def _attn_specs(cfg, n):
    d, h = cfg["d_model"], cfg["n_heads"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    return {"ln1": ((n, d), "const", 0.0), "ln2": ((n, d), "const", 0.0),
            "wq": ((n, d, h * (nope + rope)), "normal", d ** -0.5),
            "w_dkv": ((n, d, r + rope), "normal", d ** -0.5),
            "ln_kv": ((n, r), "const", 0.0),
            "w_ukv": ((n, r, h * (nope + vd)), "normal", r ** -0.5),
            "wo": ((n, h * vd, d), "normal", (h * vd) ** -0.5)}


def _swiglu_specs(d, ff, lead):
    return {"w_gate": ((*lead, d, ff), "normal", d ** -0.5),
            "w_up": ((*lead, d, ff), "normal", d ** -0.5),
            "w_down": ((*lead, ff, d), "normal", ff ** -0.5)}


def param_specs(cfg):
    """``{name: (shape, kind, arg)}``, nested as the program's tree."""
    d, v, m = cfg["d_model"], cfg["vocab_size"], cfg["moe"]
    k = cfg["first_k_dense_replace"]
    n = cfg["n_layers"] - k
    held = m.get("n_held") or m["n_experts"]
    moe = {"router": ((n, d, m["n_experts"]), "normal", d ** -0.5),
           **_swiglu_specs(d, m["expert_d_ff"], (n, held))}
    moe.update({f"shared_{w[2:]}": s
                for w, s in _swiglu_specs(d, m["shared_d_ff"], (n,)).items()})
    specs = {"embed": ((v, d), "normal", 0.02), "final_norm": ((d,), "const", 0.0),
             "out": ((v, d), "normal", d ** -0.5),
             "layers": {**_attn_specs(cfg, n), "moe": moe}}
    if k:
        specs["dense_layers"] = {**_attn_specs(cfg, k), **_swiglu_specs(d, cfg["d_ff"], (k,))}
    return specs


def inv_freq(cfg, device):
    """The rope head's inverse frequencies: YaRN's blend of ``theta **
    (-2i/dim)`` and that over ``factor`` by a linear ramp between the
    pairs that turn ``beta_fast`` and ``beta_slow`` times over the
    original context."""
    dim, theta, rs = cfg["qk_rope_head_dim"], cfg["rope_theta"], cfg["rope_scaling"]
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    if not rs:
        return base

    def pair(rotations):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    lo, hi = max(math.floor(pair(rs["beta_fast"])), 0), min(math.ceil(pair(rs["beta_slow"])),
                                                            dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / max(hi - lo, 1e-3)).clamp(0, 1)
    return base * (1 - ramp) + base / rs["factor"] * ramp


def softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
        scale *= m * m
    return scale


def rope(x, positions, freqs):
    """x (B, S, H, dim), pairs interleaved: de-interleave, rotate half."""
    ang = positions[:, None].float() * freqs[None]                    # (S, dim/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, cfg, x, precision):
    b, s, _ = x.shape
    h, nope, rp, vd = (cfg["n_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                       cfg["v_head_dim"])
    pos = torch.arange(s, device=x.device)
    freqs = inv_freq(cfg, x.device)
    q = mm(x, p["wq"], precision).reshape(b, s, h, nope + rp)
    ckv = mm(x, p["w_dkv"], precision)
    c, k_pe = ckv[..., :cfg["kv_lora_rank"]], ckv[..., cfg["kv_lora_rank"]:]
    kv = mm(rms_norm(c, p["ln_kv"], cfg["norm_eps"]), p["w_ukv"], precision)
    kv = kv.reshape(b, s, h, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, freqs)], dim=-1)
    k_pe = rope(k_pe.reshape(b, s, 1, rp), pos, freqs).expand(b, s, h, rp)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    scale = softmax_scale(cfg)
    outs = []
    for a in range(0, s, BLOCK_Q):
        qb = q[:, a:a + BLOCK_Q]
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, k) * scale
        keep = (torch.arange(s, device=x.device)[None, :]
                <= torch.arange(a, a + qb.shape[1], device=x.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v))
    o = torch.cat(outs, dim=1).reshape(b, s, h * vd)
    return mm(o, p["wo"], precision)


def swiglu(x, w_gate, w_up, w_down, precision):
    return mm(F.silu(mm(x, w_gate, precision)) * mm(x, w_up, precision), w_down, precision)


def moe(p, cfg, x, precision):
    """The held experts' part of the routed sum plus the shared experts,
    and the sequence-wise balance loss: ``(out, aux)``."""
    m = cfg["moe"]
    b, s, _ = x.shape
    e, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ p["router"], dim=-1)                      # (B, S, E)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[..., :k], sel[..., :k]
    gate = torch.zeros_like(probs).scatter(-1, sel, w)
    out = swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"], precision)
    lo = m.get("held_start", 0)
    for j in range(p["w_gate"].shape[0]):
        out = out + gate[..., lo + j, None] * swiglu(x, p["w_gate"][j], p["w_up"][j],
                                                     p["w_down"][j], precision)
    load = F.one_hot(sel.reshape(b, s * k), e).sum(1).float() / (s * k / e)
    aux = (load * probs.mean(dim=1)).sum(dim=1).mean() * m["router_aux_weight"]
    return out, aux


def _layer(stack, i):
    return {n: (_layer(v, i) if isinstance(v, dict) else v[i]) for n, v in stack.items()}


def _block(x, p, cfg, precision):
    eps = cfg["norm_eps"]
    x = x + attention(p, cfg, rms_norm(x, p["ln1"], eps), precision)
    h = rms_norm(x, p["ln2"], eps)
    if "moe" in p:
        f, aux = moe(p["moe"], cfg, h, precision)
        return x + f, aux
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"], precision), torch.zeros(
        (), device=x.device)


def loss(params, cfg, batch, *, precision="float32", rows=None):
    """The mean next-token loss of ``batch`` (``tokens`` (B, S)) plus the
    MoE layers' balance losses."""
    tokens = batch["tokens"].long()
    if rows is not None:
        tokens = tokens[:rows]
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for key in ("dense_layers", "layers"):
        stack = params.get(key)
        for i in range(stack["ln1"].shape[0] if stack else 0):
            x, a = checkpoint(_block, x, _layer(stack, i), cfg, precision, use_reentrant=False)
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    return next_token_loss(mm(x, params["out"].T, precision), tokens) + aux
