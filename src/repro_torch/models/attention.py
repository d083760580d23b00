"""GQA attention: plain, query-chunked, and banded local window.

Counterpart of ``repro/models/attention.py``. The reference's attention
is plain XLA (no Pallas kernel), so this is plain torch: scores and
softmax in float32, ``q`` scaled in float32 before QKᵀ, probabilities
cast to ``v``'s dtype before the PV product. ``scaled_dot_product_attention``
is not used: its numerics are not the reference's. The query-chunked
path is a Python loop over chunks in place of ``lax.scan``; it bounds
the live score tensor to ``(B, H, chunk_q, S_k)``.

The decode side (``KVCache``, ``cache_update``, ``decode_attention``)
keeps the reference's value semantics: ``cache_update`` returns a new
cache and never writes into the one it is given (a kept cache can be
decoded on from again, as a serving snapshot is), and the cache's
position stays a 0-d int32 tensor on the cache's device, so a decode
step reads nothing back to the host. ``pad_heads_for_tp`` zero-pads
the heads to a multiple of the tensor-parallel degree (a no-op without
an ``activation_sharding`` mesh).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import tp_size

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


def pad_heads_for_tp(q, k, v):
    """Zero-pad the head dim to the next TP multiple.

    Archs whose head count doesn't divide TP (llama4: 40, gemma: 10,
    whisper: 12 over 16-way TP) would otherwise replicate the whole
    attention computation on every model shard. Padded heads produce
    garbage that is sliced off before the output projection, so numerics
    are unchanged.

    Returns (q, k, v, original_head_count); no-op without a mesh context
    or when heads already divide TP.
    """
    tp = tp_size()
    h = q.shape[2]
    if tp <= 1 or h % tp == 0:
        return q, k, v, h
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    pad = (0, 0, 0, -(-h // tp) * tp - h)     # (hd: none, heads: to hp)
    return F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), h


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


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, H_kv, hd)
    v: torch.Tensor
    pos: torch.Tensor   # () int32: tokens already in the cache

    @staticmethod
    def zeros(b: int, s_max: int, h_kv: int, hd: int, dtype, device=None) -> "KVCache":
        return KVCache(
            k=torch.zeros((b, s_max, h_kv, hd), dtype=dtype, device=device),
            v=torch.zeros((b, s_max, h_kv, hd), dtype=dtype, device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device),
        )


def write_at_(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """In place: ``buf[:, pos : pos + S_new] = new`` with ``pos`` a 0-d
    device tensor (no read back to the host)."""
    idx = pos.long() + torch.arange(new.shape[1], device=buf.device)
    buf.index_copy_(1, idx, new.to(buf.dtype))


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Append S_new tokens at ``cache.pos``: a new cache (a clone of
    ``cache``'s buffers with the slice written), as the reference's
    ``dynamic_update_slice`` gives; ``cache`` is left unchanged."""
    k, v = cache.k.clone(), cache.v.clone()
    write_at_(k, k_new, cache.pos)
    write_at_(v, v_new, cache.pos)
    return KVCache(k=k, v=v, pos=cache.pos + k_new.shape[1])


def decode_attention(
    q: torch.Tensor, cache: KVCache, *, window: Optional[int] = None
) -> torch.Tensor:
    """Single-step attention against the cache.

    q: (B, S_q, Hq, hd), the newest S_q tokens, already in the cache.
    The cache is full-length; the mask restricts to positions < pos
    (and the window, if local attention)."""
    s_q, h_q, hd = q.shape[1], q.shape[2], q.shape[3]
    s_k = cache.k.shape[1]
    dev = q.device
    k = repeat_kv(cache.k, h_q)
    v = repeat_kv(cache.v, h_q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, k.float())
    ki = torch.arange(s_k, device=dev)[None, :]
    qi = (cache.pos - s_q) + torch.arange(s_q, device=dev)[:, None]  # new tokens' positions
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
