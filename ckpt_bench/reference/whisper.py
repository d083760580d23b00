"""Whisper's encoder-decoder (arXiv:2212.04356), plain PyTorch, float32.

The backbone as the configuration runs it: pre-LayerNorm blocks with
biases, GELU MLPs, an encoder over stub frame embeddings plus a
trainable sinusoidal table, a causal decoder with cross-attention over
the encoder's output, and the head tied to the token embedding.
Departures from the published model, shared with the program under
test: the mel/conv frontend is a stub (the batch carries frame
embeddings), the decoder's positions are the analytic sinusoid (the
published decoder learns its positions), and GELU is its tanh form.

``param_specs`` names every parameter in the program's tree (stacks of
``n`` layers on a leading axis) with its shape and how the benchmark
draws it; ``loss`` is the next-token loss of one batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ckpt_bench.reference.ops import layer_norm, gelu_tanh, mm, next_token_loss, softmax_attention


def sinusoid_table(n_pos: int, d: int) -> np.ndarray:
    """Whisper's fixed table (n_pos, d): sines then cosines, rates
    10000 ** (-i / (d/2 - 1))."""
    pos = np.arange(n_pos)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(d // 2)[None, :] / max(1, d // 2 - 1))
    return np.concatenate([np.sin(pos * inv), np.cos(pos * inv)], axis=-1).astype(np.float32)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The same rates, computed in float32 at ``positions``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(1, d // 2 - 1))
    ang = positions.float()[:, None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_specs(cfg, n):
    d, hd = cfg["d_model"], cfg["d_model"] // cfg["n_heads"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return {"wq": ((n, d, q), "normal", d ** -0.5), "bq": ((n, q), "const", 0.0),
            "wk": ((n, d, kv), "normal", d ** -0.5), "wv": ((n, d, kv), "normal", d ** -0.5),
            "bv": ((n, kv), "const", 0.0), "wo": ((n, q, d), "normal", q ** -0.5),
            "bo": ((n, d), "const", 0.0)}


def _stack_specs(cfg, n, *, decoder):
    d, ff = cfg["d_model"], cfg["d_ff"]
    specs = {"ln1_s": ((n, d), "const", 1.0), "ln1_b": ((n, d), "const", 0.0),
             "ln2_s": ((n, d), "const", 1.0), "ln2_b": ((n, d), "const", 0.0),
             "w_in": ((n, d, ff), "normal", d ** -0.5), "b_in": ((n, ff), "const", 0.0),
             "w_out": ((n, ff, d), "normal", ff ** -0.5), "b_out": ((n, d), "const", 0.0),
             "self": _attn_specs(cfg, n)}
    if decoder:
        specs.update(lnx_s=((n, d), "const", 1.0), lnx_b=((n, d), "const", 0.0),
                     cross=_attn_specs(cfg, n))
    return specs


def param_specs(cfg):
    """``{name: (shape, kind, arg)}``, nested as the program's tree; kind
    ``normal`` (arg: the std), ``const`` (the value) or ``table`` (arg:
    a float32 array)."""
    d = cfg["d_model"]
    return {
        "enc_pos": ((cfg["enc_seq"], d), "table", sinusoid_table(cfg["enc_seq"], d)),
        "enc_layers": _stack_specs(cfg, cfg["n_enc_layers"], decoder=False),
        "enc_ln_s": ((d,), "const", 1.0), "enc_ln_b": ((d,), "const", 0.0),
        "embed": ((cfg["vocab_size"], d), "normal", 0.02),
        "dec_layers": _stack_specs(cfg, cfg["n_layers"], decoder=True),
        "dec_ln_s": ((d,), "const", 1.0), "dec_ln_b": ((d,), "const", 0.0),
    }


def _layer(stack, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in stack.items()}


def _mha(p, cfg, xq, xkv, *, causal, precision):
    b, sq, _ = xq.shape
    sk = xkv.shape[1]
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // h
    q = (mm(xq, p["wq"], precision) + p["bq"]).reshape(b, sq, h, hd)
    k = mm(xkv, p["wk"], precision).reshape(b, sk, hkv, hd)
    v = (mm(xkv, p["wv"], precision) + p["bv"]).reshape(b, sk, hkv, hd)
    k, v = (t.repeat_interleave(h // hkv, dim=2) for t in (k, v))
    o = softmax_attention(q, k, v, causal=causal).reshape(b, sq, h * hd)
    return mm(o, p["wo"], precision) + p["bo"]


def _mlp(p, cfg, x, precision):
    h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg["norm_eps"])
    h = gelu_tanh(mm(h, p["w_in"], precision) + p["b_in"])
    return x + mm(h, p["w_out"], precision) + p["b_out"]


def loss(params, cfg, batch, *, precision="float32", rows=None):
    """The mean next-token loss of ``batch`` (``tokens`` (B, S) and
    ``frames`` (B, enc_seq, d)) under ``params``."""
    eps = cfg["norm_eps"]
    x = batch["frames"].float() + params["enc_pos"][None]
    for i in range(cfg["n_enc_layers"]):
        p = _layer(params["enc_layers"], i)
        hn = layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
        x = _mlp(p, cfg, x + _mha(p["self"], cfg, hn, hn, causal=False, precision=precision),
                 precision)
    memory = layer_norm(x, params["enc_ln_s"], params["enc_ln_b"], eps)
    tokens = batch["tokens"].long()
    y = params["embed"][tokens] + sinusoid_at(
        torch.arange(tokens.shape[1], device=tokens.device), cfg["d_model"])[None]
    for i in range(cfg["n_layers"]):
        p = _layer(params["dec_layers"], i)
        hn = layer_norm(y, p["ln1_s"], p["ln1_b"], eps)
        y = y + _mha(p["self"], cfg, hn, hn, causal=True, precision=precision)
        hx = layer_norm(y, p["lnx_s"], p["lnx_b"], eps)
        y = _mlp(p, cfg, y + _mha(p["cross"], cfg, hx, memory, causal=False,
                                  precision=precision), precision)
    y = layer_norm(y, params["dec_ln_s"], params["dec_ln_b"], eps)
    return next_token_loss(mm(y, params["embed"].T, precision), tokens, rows)
