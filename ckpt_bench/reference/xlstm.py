"""xLSTM's language model (arXiv:2405.04517), plain PyTorch, float32.

mLSTM and sLSTM residual blocks in the configuration's pattern, as the
program under test lays them out: pre-RMSNorm (scales stored as an
offset from one), an up-projection of 2 with a causal depthwise
convolution and SiLU on the query and key path, exponential input gates
stabilised by a running maximum, head-wise RMSNorm of the cell output,
an output gate, and a down-projection. The mLSTM is its parallel form
(the whole sequence at once: the decay matrix of cumulative log forget
gates, normalised by the larger of the row sum and ``exp(-m)``); the
sLSTM is a loop over time with a block-diagonal recurrence, one block
a head, whose gate pre-activations lie head by head in the order z, i,
f, o, and its bias is read the same way. The head is untied.

``param_specs`` names every parameter in the program's tree (a list of
per-layer dicts under ``blocks``) with its shape and how the benchmark
draws it; ``loss`` is the next-token loss of one batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ckpt_bench.reference.ops import mm, next_token_loss, rms_norm

NEG = -1e30   # the stabiliser's initial maximum


def _mlstm_specs(cfg):
    d, h, w = cfg["d_model"], cfg["n_heads"], cfg["conv_width"]
    di = 2 * d
    dense = (lambda shape, fan: (shape, "normal", fan ** -0.5))
    return {
        "ln": ((d,), "const", 0.0), "w_up": dense((d, di), d), "w_z": dense((d, di), d),
        "conv_w": ((w, di), "normal", 0.3), "conv_b": ((di,), "const", 0.0),
        "wq": dense((di, di), di), "wk": dense((di, di), di), "wv": dense((di, di), di),
        "w_i": dense((di, h), di), "w_f": dense((di, h), di),
        "b_i": ((h,), "const", 0.0), "b_f": ((h,), "const", 3.0),
        "gn": ((h, di // h), "const", 0.0), "w_down": dense((di, d), di),
    }


def _slstm_specs(cfg):
    d, h = cfg["d_model"], cfg["n_heads"]
    hd = d // h
    bias = np.concatenate([np.zeros(2 * d), np.full(d, 3.0), np.zeros(d)]).astype(np.float32)
    return {
        "ln": ((d,), "const", 0.0), "w": ((d, 4 * d), "normal", d ** -0.5),
        "r": ((h, hd, 4 * hd), "const", 0.0), "b": ((4 * d,), "table", bias),
        "gn": ((h, hd), "const", 0.0), "w_down": ((d, d), "normal", d ** -0.5),
    }


def layer_kinds(cfg):
    pattern = cfg["block_pattern"]
    return [pattern[i % len(pattern)] for i in range(cfg["n_layers"])]


def param_specs(cfg):
    """``{name: (shape, kind, arg)}``, nested as the program's tree; kind
    ``normal`` (arg: the std), ``const`` (the value) or ``table`` (arg:
    a float32 array)."""
    v, d = cfg["vocab_size"], cfg["d_model"]
    blocks = [_mlstm_specs(cfg) if k == "mlstm" else _slstm_specs(cfg) for k in layer_kinds(cfg)]
    return {"embed": ((v, d), "normal", 0.02), "final_norm": ((d,), "const", 0.0),
            "out": ((v, d), "normal", v ** -0.5), "blocks": blocks}


def _conv(x, w, b):
    """Causal depthwise convolution: out[t] = sum_i x[t - i] * w[W-1-i] + b."""
    width, s = w.shape[0], x.shape[1]
    out = b.expand_as(x)
    for i in range(width):
        out = out + F.pad(x, (0, 0, i, 0))[:, :s] * w[width - 1 - i]
    return out


def _mlstm_cell(q, k, v, logf, logi):
    """q, k, v (B,S,H,hd); logf, logi (B,S,H) -> (B,S,H,hd)."""
    s, hd = q.shape[1], q.shape[3]
    cum = torch.cumsum(logf, dim=1).transpose(1, 2)                       # (B,H,S)
    dmat = cum[..., :, None] - cum[..., None, :] + logi.transpose(1, 2)[..., None, :]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~keep, float("-inf"))
    m = dmat.amax(-1, keepdim=True).clamp_min(NEG)
    c = torch.einsum("bihd,bjhd->bhij", q, k) * hd ** -0.5 * torch.exp(dmat - m)
    denom = torch.maximum(c.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bhij,bjhd->bihd", c / denom, v)


def _mlstm(p, cfg, x, precision):
    b, s, _ = x.shape
    h = cfg["n_heads"]
    xn = rms_norm(x, p["ln"], cfg["norm_eps"])
    xm, z = mm(xn, p["w_up"], precision), mm(xn, p["w_z"], precision)
    xc = F.silu(_conv(xm, p["conv_w"], p["conv_b"]))
    di = xm.shape[-1]
    q = mm(xc, p["wq"], precision).reshape(b, s, h, di // h)
    k = mm(xc, p["wk"], precision).reshape(b, s, h, di // h)
    v = mm(xm, p["wv"], precision).reshape(b, s, h, di // h)
    logi = mm(xc, p["w_i"], precision) + p["b_i"]
    logf = F.logsigmoid(mm(xc, p["w_f"], precision) + p["b_f"])
    hout = rms_norm(_mlstm_cell(q, k, v, logf, logi), p["gn"], cfg["norm_eps"])
    return x + mm(hout.reshape(b, s, di) * F.silu(z), p["w_down"], precision)


def _slstm(p, cfg, x, precision):
    b, s, d = x.shape
    h = cfg["n_heads"]
    hd = d // h
    xn = rms_norm(x, p["ln"], cfg["norm_eps"])
    pre_x = mm(xn, p["w"], precision).reshape(b, s, h, 4 * hd) + p["b"].reshape(h, 4 * hd)
    hs = torch.zeros(b, h, hd, device=x.device)
    c = torch.zeros_like(hs)
    n = torch.full_like(hs, 1e-6)
    m = torch.full_like(hs, NEG)
    ys = []
    for t in range(s):
        pre = pre_x[:, t] + torch.einsum("bhd,hde->bhe", hs, p["r"])
        zp, ip, fp, op = pre.split(hd, dim=-1)
        lfm = F.logsigmoid(fp) + m
        m_new = torch.maximum(lfm, ip)
        decay, gate = torch.exp(lfm - m_new), torch.exp(ip - m_new)
        c = decay * c + gate * torch.tanh(zp)
        n = decay * n + gate
        hs = torch.sigmoid(op) * c / n.clamp_min(1e-6)
        m = m_new
        ys.append(hs)
    ys = rms_norm(torch.stack(ys, dim=1), p["gn"], cfg["norm_eps"])
    return x + mm(ys.reshape(b, s, d), p["w_down"], precision)


def loss(params, cfg, batch, *, precision="float32", rows=None):
    """The mean next-token loss of ``batch`` (``tokens`` (B, S)) under
    ``params``."""
    tokens = batch["tokens"].long()
    x = params["embed"][tokens]
    for kind, p in zip(layer_kinds(cfg), params["blocks"]):
        x = (_mlstm if kind == "mlstm" else _slstm)(p, cfg, x, precision)
    x = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    return next_token_loss(mm(x, params["out"].T, precision), tokens, rows)
