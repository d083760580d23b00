"""GQA attention: plain, query-chunked, and banded local window.

Counterpart of ``repro/models/attention.py``. The reference's attention
is plain XLA (no Pallas kernel), so this is plain torch: scores and
softmax in float32, ``q`` scaled in float32 before QKᵀ, probabilities
cast to ``v``'s dtype before the PV product. ``scaled_dot_product_attention``
is not used: its numerics are not the reference's. The query-chunked
path is a Python loop over chunks in place of ``lax.scan``; it bounds
the live score tensor to ``(B, H, chunk_q, S_k)``.

``KVCache``/``decode_attention`` come with the serving slice and
``pad_heads_for_tp`` with tensor parallelism (a no-op without a mesh).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scores_mask(
    s_q: int, s_k: int, *, causal: bool, window: Optional[int], q_offset: int, device
) -> torch.Tensor:
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    m = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


def repeat_kv(k: torch.Tensor, h_q: int) -> torch.Tensor:
    """(B, S, H_kv, hd) -> (B, S, H_q, hd) by group repetition."""
    h_kv = k.shape[2]
    if h_kv == h_q:
        return k
    if h_q % h_kv:
        raise ValueError(f"n_heads {h_q} not a multiple of n_kv_heads {h_kv}")
    return torch.repeat_interleave(k, h_q // h_kv, dim=2)


def _attend_block(q, k, v, mask) -> torch.Tensor:
    """q: (B,Sq,H,hd) k/v: (B,Sk,H,hd) mask: (Sq,Sk) -> (B,Sq,H,hd)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk_q: Optional[int] = 1024,
) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd)."""
    b, s_q, h_q, hd = q.shape
    s_k = k.shape[1]
    dev = q.device
    k = repeat_kv(k, h_q)
    v = repeat_kv(v, h_q)

    if chunk_q is None or s_q <= chunk_q or s_q % chunk_q:
        mask = _scores_mask(s_q, s_k, causal=causal, window=window,
                            q_offset=q_offset, device=dev)
        return _attend_block(q, k, v, mask)

    # banded path: local attention only ever sees `window + chunk_q` keys
    # per query chunk
    band = None
    if window is not None and causal and q_offset == 0 and s_k == s_q:
        band = window + chunk_q
        if band >= s_k:
            band = None

    outs = []
    for idx in range(s_q // chunk_q):
        qi = q[:, idx * chunk_q : (idx + 1) * chunk_q]
        off = q_offset + idx * chunk_q
        if band is None:
            mask = _scores_mask(chunk_q, s_k, causal=causal, window=window,
                                q_offset=off, device=dev)
            outs.append(_attend_block(qi, k, v, mask))
            continue
        start = min(max(off + chunk_q - band, 0), s_k - band)
        kb = k[:, start : start + band]
        vb = v[:, start : start + band]
        qi_pos = off + torch.arange(chunk_q, device=dev)[:, None]
        kb_pos = start + torch.arange(band, device=dev)[None, :]
        mask = (kb_pos <= qi_pos) & (kb_pos > qi_pos - window)
        outs.append(_attend_block(qi, kb, vb, mask))
    return torch.cat(outs, dim=1)
