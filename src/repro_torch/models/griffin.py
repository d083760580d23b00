"""Griffin / RecurrentGemma (arXiv:2402.19427): RG-LRU + local attention.

Counterpart of ``repro/models/griffin.py``, op for op. Layer pattern
2:1: two recurrent (RG-LRU) residual blocks per local-attention (MQA,
windowed) block; every layer also carries a GeGLU MLP residual. The
RG-LRU trains through a parallel prefix over its diagonal linear
recurrence ``h_t = a_t h_{t-1} + b_t`` and decodes with O(1) state; local
attention decodes against a ring-buffer KV cache of window size.

The reference's ``lax.associative_scan`` with ``_combine`` becomes
:func:`_assoc_scan`, a log-depth doubling scan with the same operator.
It never divides: ``log a = -8 softplus(lam) r`` is about -4.3 a step at
init, so a cumulative product of ``a`` underflows float32 within a few
dozen tokens, and ``exp(cumsum(log a))`` with a division would give
inf/NaN. Sequences longer than 8192 tokens (and multiples of 512) run
the reference's chunked form: a Python loop over 512-token chunks (its
``lax.scan``) carrying the hidden state, each chunk a parallel scan.

The gate weights ``w_r``, ``b_r``, ``w_i``, ``b_i`` and ``lam`` stay
float32 whatever the parameter dtype, as in the reference, so their
AdamW moments are float32 too. ``blocks`` is a list of per-layer dicts
(kinds differ); :meth:`Griffin.state_tree` is the reference's tree
(embeddings tied, no ``out``). ``pad_heads_for_tp`` (10 heads pad to
16 under 16-way TP) and the ``shard_act`` pins sit where the reference
has them; they are no-ops without a mesh. ``decode_step`` returns a new state and leaves the given one
unchanged: each ring write goes into a clone.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    NEG_INF, attention, pad_heads_for_tp, repeat_kv, write_at_,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cross_entropy, new_param, rms_norm
from repro_torch.models.sharding import shard_act
from repro_torch.models.xlstm import _conv_causal, _conv_step

_C = 8.0  # RG-LRU gate sharpness constant (Griffin paper)
# gate parameters kept float32 whatever the parameter dtype
_FLOAT32_LEAVES = ("w_r", "b_r", "w_i", "b_i", "lam")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru_coeffs(p, x):
    """x: (..., dr) -> (a, b) of the recurrence h = a*h_prev + b."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_r"].float() + p["b_r"])
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"])
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8)) * (i * xf)
    return a, b


def _combine(l, r):
    al, bl = l
    ar, br = r
    return al * ar, ar * bl + br


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` over dim 1 (log-depth doubling):
    ``(A_t, B_t)`` with ``A_t = a_0 ... a_t`` and ``B_t`` the recurrence
    from ``h_{-1} = 0``."""
    s = a.shape[1]
    d = 1
    while d < s:
        na, nb = _combine((a[:, :-d], b[:, :-d]), (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], na], dim=1)
        b = torch.cat([b[:, :d], nb], dim=1)
        d *= 2
    return a, b


def rglru_scan(p, x, *, chunk: int = 512):
    """x: (B,S,dr) -> (B,S,dr). The full parallel scan up to 8192 tokens
    (or when ``chunk`` does not divide S); past that, 512-token chunks
    whose gates are computed inside the chunk loop, the hidden state
    carried between them (the reference's peak-memory form)."""
    s = x.shape[1]
    if s <= max(chunk, 8192) or s % chunk:
        a, b = _rglru_coeffs(p, x)
        _, b_c = _assoc_scan(a, b)
        return b_c.to(x.dtype)  # h_0 = 0 => h_t = b_cumulative

    # the gate weights pinned once, outside the chunk loop
    p = dict(p, w_r=shard_act(p["w_r"], None, "tp"), w_i=shard_act(p["w_i"], None, "tp"))
    h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    hs = []
    for xi in x.split(chunk, dim=1):
        ai, bi = _rglru_coeffs(p, xi)
        cum_a, cum_b = _assoc_scan(ai, bi)
        h = cum_b + cum_a * h0[:, None, :]
        h0 = h[:, -1]
        hs.append(h.to(x.dtype))
    return torch.cat(hs, dim=1)


def rglru_step(p, h_prev, x_t):
    a, b = _rglru_coeffs(p, x_t)
    h = a * h_prev + b
    return h, h.to(x_t.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, kind: str, generator, device) -> nn.ParameterDict:
    d = cfg.d_model
    dr = d  # RecurrentGemma: lru_width == d_model
    hd = cfg.hd
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd

    def new(name, shape, init="dense", **kw):
        dtype = torch.float32 if name in _FLOAT32_LEAVES else cfg.pdt
        return name, new_param(generator, shape, dtype, device, init, **kw)

    p = [new("ln1", (d,), 0.0), new("ln2", (d,), 0.0),
         # GeGLU MLP on every layer
         new("m_gate", (d, cfg.d_ff)), new("m_up", (d, cfg.d_ff)), new("m_down", (cfg.d_ff, d))]
    if kind == "rglru":
        p += [new("w_x", (d, dr)), new("w_gate", (d, dr)),
              new("conv_w", (cfg.conv_width, dr), scale=0.3), new("conv_b", (dr,), 0.0),
              new("w_r", (dr, dr), scale=0.02), new("b_r", (dr,), 0.0),
              new("w_i", (dr, dr), scale=0.02), new("b_i", (dr,), 0.0),
              new("lam", (dr,), 0.65), new("w_out", (dr, d))]
    elif kind == "attn":
        p += [new("wq", (d, q_dim)), new("wk", (d, kv_dim)), new("wv", (d, kv_dim)),
              new("wo", (q_dim, d))]
    else:
        raise ValueError(kind)
    return nn.ParameterDict(dict(p))


def _mlp(p, cfg: ModelConfig, x):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    dt = h.dtype
    kinds = ("dp",) + (None,) * (h.ndim - 2) + ("tp",)
    g = shard_act(h @ p["m_gate"].to(dt), *kinds)
    u = shard_act(h @ p["m_up"].to(dt), *kinds)
    z = F.gelu(g.float(), approximate="tanh").to(dt) * u
    return x + z @ p["m_down"].to(dt)


def _rglru_in(p, cfg: ModelConfig, x):
    """The recurrent branch's input ``xr`` (before the conv) and its
    GeLU gate, from the normed residual stream."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    dt = h.dtype
    xr = shard_act(h @ p["w_x"].to(dt), "dp", None, "tp")
    gate = F.gelu((h @ p["w_gate"].to(dt)).float(), approximate="tanh").to(dt)
    return xr, gate


def _rglru_out(p, cfg: ModelConfig, x, y, gate):
    y = shard_act(y, "dp", None, "tp")
    x = shard_act(x + (y * gate) @ p["w_out"].to(x.dtype), "dp", None, None)
    return _mlp(p, cfg, x)


def rglru_block(p, cfg: ModelConfig, x):
    xr, gate = _rglru_in(p, cfg, x)
    y = rglru_scan(p, _conv_causal(xr, p["conv_w"], p["conv_b"]))
    return _rglru_out(p, cfg, x, y, gate)


def _attn_qkv(p, cfg: ModelConfig, x, positions):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    dt = h.dtype
    b, s, _ = h.shape
    hd = cfg.hd
    q = (h @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p, cfg: ModelConfig, x, o):
    b, s = o.shape[:2]
    x = x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return _mlp(p, cfg, x)


def _attn_block_kv(p, cfg: ModelConfig, x, positions):
    q, k, v = _attn_qkv(p, cfg, x, positions)
    qp, kp, vp, n_h = pad_heads_for_tp(q, k, v)
    qp = shard_act(qp, "dp", None, "tp", None)
    o = attention(qp, kp, vp, causal=True, window=cfg.window, chunk_q=1024)[:, :, :n_h]
    return _attn_out(p, cfg, x, o), k, v


def attn_block(p, cfg: ModelConfig, x, positions):
    return _attn_block_kv(p, cfg, x, positions)[0]


# ---------------------------------------------------------------------------
# LM assembly
# ---------------------------------------------------------------------------


class Griffin(nn.Module):
    """RecurrentGemma's parameters: ``embed`` (tied), ``final_norm`` and
    one ``ParameterDict`` a layer in ``blocks``; initialised from a
    ``generator`` as the reference initialises them, or left
    uninitialised without one."""

    def __init__(self, cfg: ModelConfig, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            [init_block(cfg, kind, generator, device) for kind in cfg.layer_kinds()])
        v, d = cfg.vocab_size, cfg.d_model
        self.embed = new_param(generator, (v, d), cfg.pdt, device, "embed")
        self.final_norm = new_param(generator, (d,), cfg.pdt, device, 0.0)

    def state_tree(self) -> Dict[str, Any]:
        """The reference's parameter tree; its leaves are this module's
        own parameters (not copies)."""
        return {
            "embed": self.embed,
            "final_norm": self.final_norm,
            "blocks": [dict(b.items()) for b in self.blocks],
        }

    def forward(self, tokens: torch.Tensor, *, remat: bool = False):
        return forward(self.state_tree(), self.cfg, tokens, remat=remat)


def _embed(params, cfg: ModelConfig, tokens):
    """The token embeddings scaled by sqrt(d_model), computed in the
    compute dtype as the reference computes it."""
    scale = torch.sqrt(torch.tensor(cfg.d_model, dtype=cfg.cdt, device=params["embed"].device))
    return shard_act(params["embed"].to(cfg.cdt)[tokens.long()] * scale, "dp", None, None)


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].to(cfg.cdt).T                     # tied


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = True, **_):
    """-> (logits (B, S, V), a zero aux loss () float32)."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    for kind, p in zip(cfg.layer_kinds(), params["blocks"]):
        if kind == "rglru":
            fn = lambda h, p=p: rglru_block(p, cfg, h)
        else:
            fn = lambda h, p=p: attn_block(p, cfg, h, positions)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    logits = shard_act(_logits(params, cfg, x), "dp", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(params, cfg: ModelConfig, tokens, *, remat: bool = True, **_):
    logits, aux = forward(params, cfg, tokens, remat=remat)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce, {"ce": ce, "aux": aux}


# -- decode: ring-buffer KV for attn layers, O(1) state for rglru -----------


def init_state(params, cfg: ModelConfig, b: int, s_max: int = 0, *, device=None):
    """Decode state: O(1) rglru state + ring-buffer KV of window size.

    Shapes depend only on cfg; it lives on the device of ``params``'
    embedding, or on ``device`` when ``params`` is None."""
    del s_max
    dev = params["embed"].device if params is not None else device
    win = cfg.window or 2048
    states: List[Dict[str, torch.Tensor]] = []
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            states.append({
                "h": torch.zeros((b, cfg.d_model), dtype=torch.float32, device=dev),
                "conv": torch.zeros((b, cfg.conv_width - 1, cfg.d_model), dtype=cfg.cdt,
                                    device=dev),
            })
        else:
            kv = (b, win, cfg.n_kv_heads, cfg.hd)
            states.append({
                "k": torch.zeros(kv, dtype=cfg.cdt, device=dev),
                "v": torch.zeros(kv, dtype=cfg.cdt, device=dev),
                "slot_pos": torch.full((win,), -1, dtype=torch.int32, device=dev),
            })
    return {"layers": states, "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _attn_decode(p, cfg: ModelConfig, st, x, pos):
    hd = cfg.hd
    q, k, v = _attn_qkv(p, cfg, x, pos[None, None])
    win = st["k"].shape[1]
    slot = pos % win
    kc, vc = st["k"].clone(), st["v"].clone()
    write_at_(kc, k, slot)
    write_at_(vc, v, slot)
    slot_pos = st["slot_pos"].clone()
    slot_pos.index_copy_(0, slot.long().reshape(1), pos.reshape(1).to(slot_pos.dtype))
    kf = repeat_kv(kc, cfg.n_heads)
    vf = repeat_kv(vc, cfg.n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kf.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - win)
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(vf.dtype), vf)
    return {"k": kc, "v": vc, "slot_pos": slot_pos}, _attn_out(p, cfg, x, o)


def _rglru_decode(p, cfg: ModelConfig, st, x):
    xr, gate = _rglru_in(p, cfg, x[:, 0])
    conv_out, conv_state = _conv_step(xr, st["conv"], p["conv_w"], p["conv_b"])
    hnew, y = rglru_step(p, st["h"], conv_out)
    x = x + ((y * gate) @ p["w_out"].to(x.dtype))[:, None]
    return {"h": hnew, "conv": conv_state}, _mlp(p, cfg, x)


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B, 1) -> (logits (B, V), the next state); ``state`` is
    left unchanged."""
    x = _embed(params, cfg, tokens)
    pos = state["pos"]
    new_states = []
    for kind, p, st in zip(cfg.layer_kinds(), params["blocks"], state["layers"]):
        if kind == "rglru":
            st2, x = _rglru_decode(p, cfg, st, x)
        else:
            st2, x = _attn_decode(p, cfg, st, x, pos)
        new_states.append(st2)
    return _logits(params, cfg, x[:, 0]), {"layers": new_states, "pos": pos + 1}


def _ring_from_full(k, v, s, win, cfg: ModelConfig):
    """Place the last ``win`` roped K/V at their ring slots (slot = pos % win)."""
    b = k.shape[0]
    dev = k.device
    kc = torch.zeros((b, win, cfg.n_kv_heads, cfg.hd), dtype=cfg.cdt, device=dev)
    vc = torch.zeros_like(kc)
    n_keep = min(s, win)
    pos = torch.arange(s - n_keep, s, device=dev)                 # absolute positions
    slots = pos % win
    kc[:, slots] = k[:, s - n_keep :].to(cfg.cdt)
    vc[:, slots] = v[:, s - n_keep :].to(cfg.cdt)
    slot_pos = torch.full((win,), -1, dtype=torch.int32, device=dev)
    slot_pos[slots] = pos.to(torch.int32)
    return {"k": kc, "v": vc, "slot_pos": slot_pos}


def _conv_tail(xr, w: int):
    """Last w pre-conv inputs, left-padded when the prompt is shorter."""
    s = xr.shape[1]
    tail = xr[:, max(0, s - w):]
    if tail.shape[1] < w:
        tail = F.pad(tail, (0, 0, w - tail.shape[1], 0))
    return tail


def prefill(params, cfg: ModelConfig, tokens, *, s_max: Optional[int] = None, **_):
    """Parallel prefill: one teacher-forced forward pass that also
    extracts the decode state per layer (RG-LRU carry + conv tail, or the
    last ``window`` ring KV slots) -> (state, logits of the last token)."""
    b, s = tokens.shape
    win = cfg.window or 2048
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    states: List[Dict[str, torch.Tensor]] = []
    for kind, p in zip(cfg.layer_kinds(), params["blocks"]):
        if kind == "rglru":
            xr, gate = _rglru_in(p, cfg, x)
            a, bb = _rglru_coeffs(p, _conv_causal(xr, p["conv_w"], p["conv_b"]))
            _, h_all = _assoc_scan(a, bb)
            x = _rglru_out(p, cfg, x, h_all.to(x.dtype), gate)
            states.append({
                "h": h_all[:, -1].float().contiguous(),
                "conv": _conv_tail(xr, cfg.conv_width - 1).to(cfg.cdt).contiguous(),
            })
        else:
            x, k, v = _attn_block_kv(p, cfg, x, positions)
            states.append(_ring_from_full(k, v, s, win, cfg))
    logits = _logits(params, cfg, x[:, -1])
    return {"layers": states, "pos": torch.tensor(s, dtype=torch.int32, device=x.device)}, logits
