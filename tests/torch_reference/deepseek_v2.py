"""DeepSeek-V2's decoder (arXiv:2405.04434; the equations of the public
``modeling_deepseek.py``), plain PyTorch in float32 with TF32 off: no
kernel, no cache, no import of the port.

``cfg`` is a plain dict with the port's ``ModelConfig`` field names
(``dataclasses.asdict`` of one), its ``moe`` and ``rope_scaling`` nested
dicts. ``params`` is a tree with the port's names: ``embed``, ``out``,
``final_norm`` and the stacks ``dense_layers`` (the leading dense
layers) and ``layers`` (the MoE layers, their FFN under ``moe``), each
leaf stacked over its layers. Norm scales are offsets from one
(``x / rms(x) * (1 + scale)``).

Departures from the published model: random weights; the vocabulary is
whatever the configuration gives (a slice); a MoE layer holds the
experts ``held_start .. held_start + n_held - 1`` of the router's
``n_experts`` and adds only their part of the routed sum (``moe`` with
``held=None`` is the uncut layer); the loss adds the balance losses to
the next-token loss (the published code adds only their gradient); the
rope part of queries and keys is left de-interleaved (scores are
unchanged).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F


@contextmanager
def no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def rms_norm(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def yarn_ramp(cfg):
    """YaRN's ramp ``(low, high)``: the rotary pairs that turn
    ``beta_fast`` and ``beta_slow`` times over the original context."""
    dim, theta, rs = cfg["qk_rope_head_dim"], cfg["rope_theta"], cfg["rope_scaling"]

    def pair(rotations):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    return max(math.floor(pair(rs["beta_fast"])), 0), min(math.ceil(pair(rs["beta_slow"])),
                                                          dim - 1)


def inv_freq(cfg):
    dim = cfg["qk_rope_head_dim"]
    base = 1.0 / cfg["rope_theta"] ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    rs = cfg["rope_scaling"]
    if not rs:
        return base
    lo, hi = yarn_ramp(cfg)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    return base * (1 - ramp) + base / rs["factor"] * ramp


def mscale(cfg):
    """YaRN's ``0.1 * mscale_all_dim * ln(factor) + 1``; the scores are
    scaled by its square."""
    rs = cfg["rope_scaling"]
    if not rs or not rs.get("mscale_all_dim") or rs["factor"] <= 1:
        return 1.0
    return 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0


def rope(x, positions, freqs):
    """x (B, S, H, dim), pairs interleaved: de-interleave, rotate half."""
    ang = positions[:, None].float() * freqs.to(x.device)[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, cfg, x):
    b, s, _ = x.shape
    h, nope, rp, vd = (cfg["n_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                       cfg["v_head_dim"])
    pos = torch.arange(s, device=x.device)
    freqs = inv_freq(cfg)
    q = (x @ p["wq"]).reshape(b, s, h, nope + rp)
    ckv = x @ p["w_dkv"]
    c, k_pe = ckv[..., :cfg["kv_lora_rank"]], ckv[..., cfg["kv_lora_rank"]:]
    kv = (rms_norm(c, p["ln_kv"], cfg["norm_eps"]) @ p["w_ukv"]).reshape(b, s, h, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, freqs)], dim=-1)
    k = torch.cat([kv[..., :nope], rope(k_pe.reshape(b, s, 1, rp), pos, freqs).expand(
        b, s, h, rp)], dim=-1)
    v = kv[..., nope:]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * ((nope + rp) ** -0.5 * mscale(cfg) ** 2)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * vd)
    return o @ p["wo"]


def route(p, cfg, x):
    """``(probs (B, S, E), sel (B, S, K), gate (B, S, E))``: the router's
    softmax, the greedy top-k (the lower index first on ties) and each
    expert's weight for each token (zero where not chosen)."""
    m = cfg["moe"]
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[..., :m["top_k"]], sel[..., :m["top_k"]]
    gate = torch.zeros_like(probs).scatter(-1, sel, w)
    return probs, sel, gate


def moe(p, cfg, x, held=None):
    """``(out, aux)``: the shared experts plus the routed sum over the
    experts ``held`` (a range of the router's; all where ``None``),
    whose weights ``p["w_*"]`` holds in that order, and the
    sequence-wise balance loss over every expert."""
    m = cfg["moe"]
    b, s, _ = x.shape
    e, k = m["n_experts"], m["top_k"]
    probs, sel, gate = route(p, cfg, x)
    held = range(e) if held is None else held
    out = swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    for j, ex in enumerate(held):
        out = out + gate[..., ex, None] * swiglu(x, p["w_gate"][j], p["w_up"][j],
                                                 p["w_down"][j])
    load = F.one_hot(sel.reshape(b, s * k), e).sum(1).float() / (s * k / e)
    aux = (load * probs.mean(dim=1)).sum(dim=1).mean() * m["router_aux_weight"]
    return out, aux


def held_range(cfg):
    m = cfg["moe"]
    return range(m["held_start"], m["held_start"] + (m["n_held"] or m["n_experts"]))


def _layer(stack, i):
    return {n: (_layer(v, i) if isinstance(v, dict) else v[i]) for n, v in stack.items()}


def forward(params, cfg, tokens):
    """-> (logits (B, S, V), the balance losses' sum)."""
    eps = cfg["norm_eps"]
    with no_tf32():
        x = params["embed"][tokens.long()]
        aux = torch.zeros(())
        for key in ("dense_layers", "layers"):
            stack = params.get(key)
            for i in range(stack["ln1"].shape[0] if stack else 0):
                p = _layer(stack, i)
                x = x + attention(p, cfg, rms_norm(x, p["ln1"], eps))
                h = rms_norm(x, p["ln2"], eps)
                if "moe" in p:
                    f, a = moe(p["moe"], cfg, h, held_range(cfg))
                    x, aux = x + f, aux + a
                else:
                    x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        x = rms_norm(x, params["final_norm"], eps)
        return x @ params["out"].T, aux


def loss(params, cfg, tokens):
    logits, aux = forward(params, cfg, tokens)
    v = logits.shape[-1]
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, v), tokens[:, 1:].reshape(-1).long())
    return ce + aux


def routing_counts(params, cfg, tokens):
    """The MoE layers' routing counts summed over the layers, from the
    reference's own forward: every slot, the held experts' slots, the
    busiest held expert's slots."""
    eps = cfg["norm_eps"]
    held = held_range(cfg)
    total = [0, 0, 0]
    with no_tf32(), torch.no_grad():
        x = params["embed"][tokens.long()]
        for key in ("dense_layers", "layers"):
            stack = params.get(key)
            for i in range(stack["ln1"].shape[0] if stack else 0):
                p = _layer(stack, i)
                x = x + attention(p, cfg, rms_norm(x, p["ln1"], eps))
                h = rms_norm(x, p["ln2"], eps)
                if "moe" in p:
                    sel = route(p["moe"], cfg, h)[1]
                    per = torch.bincount(sel.reshape(-1), minlength=cfg["moe"]["n_experts"])
                    per = per[held.start:held.stop]
                    total = [total[0] + sel.numel(), total[1] + int(per.sum()),
                             total[2] + int(per.max())]
                    x = x + moe(p["moe"], cfg, h, held)[0]
                else:
                    x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return total
