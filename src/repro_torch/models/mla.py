"""Multi-head latent attention (MLA) of DeepSeek-V2 (arXiv:2405.04434), for
training.

Queries are not compressed (``q_lora_rank`` null, as in DeepSeek-V2-Lite):
``q = x W_q`` splits per head into ``q_nope`` (``qk_nope_head_dim``) and
``q_pe`` (``qk_rope_head_dim``). Keys and values come from a latent:
``[c, k_pe] = x W_dkv`` with ``c`` of ``kv_lora_rank`` dims and ``k_pe``
one rope head shared by every head; ``[k_nope, v] = rms_norm(c) W_ukv``
per head. Rope (YaRN's frequencies where ``rope_scaling`` is set, with
DeepSeek's de-interleave) goes on ``q_pe`` and ``k_pe`` only; keys are
``[k_nope, k_pe]``. The scores are causal, in float32 as the port's
:func:`~repro_torch.models.attention.attention` computes them, at
``(qk_nope + qk_rope) ** -0.5`` times YaRN's ``mscale(factor,
mscale_all_dim) ** 2``; the output is ``o W_o``.

Parameters of one layer: ``wq`` (d, H * (nope + rope)), ``w_dkv`` (d,
kv_lora_rank + rope), ``ln_kv`` (kv_lora_rank,), ``w_ukv`` (kv_lora_rank,
H * (nope + v)), ``wo`` (H * v, d). Serving from a latent cache is not
ported: :func:`check_not_mla` raises for the serving entry points.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope_interleaved, rms_norm, rope_freqs, yarn_inv_freq, yarn_mscale,
)
from repro_torch.models.sharding import shard_act


def shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {"wq": (d, h * qk), "w_dkv": (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "ln_kv": (cfg.kv_lora_rank,),
            "w_ukv": (cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": (h * cfg.v_head_dim, d)}


def softmax_scale(cfg: ModelConfig) -> float:
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.mscale_all_dim:
        m = yarn_mscale(rs.factor, rs.mscale_all_dim)
        scale = scale * m * m
    return scale


def inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The rope head's inverse frequencies (cos and sin unscaled, see
    :class:`~repro_torch.models.config.RopeScaling`)."""
    dim, rs = cfg.qk_rope_head_dim, cfg.rope_scaling
    if rs is None:
        return rope_freqs(dim, cfg.rope_theta, device=device)
    return yarn_inv_freq(dim, cfg.rope_theta, rs, device=device)


def mla(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
        chunk_q=1024) -> torch.Tensor:
    """x: (B, S, d), already normed -> the attention's output (B, S, d)."""
    b, s, _ = x.shape
    h, nope, rope, vd = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
    dt = x.dtype
    freqs = inv_freq(cfg, device=x.device)
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    c, k_pe = (x @ p["w_dkv"].to(dt)).split([cfg.kv_lora_rank, rope], dim=-1)
    kv = (rms_norm(c, p["ln_kv"], cfg.norm_eps) @ p["w_ukv"].to(dt)).reshape(b, s, h, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q_pe = apply_rope_interleaved(q_pe, positions, freqs)
    k_pe = apply_rope_interleaved(k_pe.reshape(b, s, 1, rope), positions, freqs)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, rope)], dim=-1)
    q = shard_act(q, "dp", None, "tp", None)
    k = shard_act(k, "dp", None, "tp", None)
    v = shard_act(v, "dp", None, "tp", None)
    o = attention(q, k, v, causal=True, chunk_q=chunk_q, scale=softmax_scale(cfg))
    o = shard_act(o, "dp", None, "tp", None).reshape(b, s, h * vd)
    return shard_act(o @ p["wo"].to(dt), "dp", None, None)


def check_not_mla(cfg: ModelConfig, what: str) -> None:
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: {what} of latent attention (MLA) is not ported; it needs a "
            "latent cache. MLA configurations train only.")
