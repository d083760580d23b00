"""Decoder-only transformer LM, dense family (llama/qwen style).

Counterpart of ``repro/models/transformer.py``: pre-RMSNorm, GQA
attention with RoPE, SwiGLU MLP. Parameters keep the reference's
layout: one tensor per name, stacked over layers (``layers.wq`` is
``(L, d, q_dim)``), so :meth:`Transformer.state_tree` is the nested dict
the JAX init gives, with the same keys, shapes and dtypes, and a train
checkpoint of either package restores in the other.

The forward pass ``unbind``\\ s each stack once (backward is then one
``stack`` a name, where indexing ``w[l]`` in each layer would make
autograd build a full zero stack per layer) and casts each layer's
slice to the compute dtype inside the block, as the reference does
inside its scan. ``remat`` recomputes each block in backward
(``torch.utils.checkpoint``).

Serving: ``prefill`` runs the prompt through the same attention paths
as ``forward`` (unchunked, or query-chunked past ``chunk_q``) and fills
a ``DecodeCache`` padded to ``s_max``; ``decode_step`` feeds one token a
sequence through the same pieces (``rms_norm``, RoPE at ``cache.pos``,
``swiglu``) against the cache. The cache is stored in the compute
dtype. ``decode_step`` returns a new cache, as the reference's scan
does: it clones the given cache once a step and writes each layer's new
key and value into the clone, so the cache it was given stays valid.

Not ported yet: the MoE FFN and VLM patches (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import KVCache, attention, decode_attention, write_at_
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, embed_init, rms_norm, swiglu

MOE_TODO = "the MoE FFN is not ported yet (ROADMAP Queue 1 item 7)"
VLM_TODO = "VLM patch inputs are not ported yet (ROADMAP Queue 1 item 7)"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer shape of every stacked parameter, in the reference's
    order of initialisation."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    d, hd = cfg.d_model, cfg.hd
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd
    shapes = {"wq": (d, q_dim), "wk": (d, kv_dim), "wv": (d, kv_dim), "wo": (q_dim, d),
              "ln1": (d,), "ln2": (d,)}
    if cfg.qkv_bias:
        shapes.update(bq=(q_dim,), bk=(kv_dim,), bv=(kv_dim,))
    shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
    return shapes


_ZERO_INIT = ("ln1", "ln2", "bq", "bk", "bv")


class Transformer(nn.Module):
    """The dense decoder's parameters, stacked over layers.

    With a ``generator`` the parameters are initialised as the
    reference initialises them (normal draws, from the generator's
    device, then placed on ``device``); without one they are left
    uninitialised (``torch.empty``), to be loaded.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        pdt = cfg.pdt
        v, d, n = cfg.vocab_size, cfg.d_model, cfg.n_layers

        def make(shape, init, *, layers=None):
            full = shape if layers is None else (layers, *shape)
            if generator is None:
                return nn.Parameter(torch.empty(full, dtype=pdt, device=device))
            if init == "zeros":
                return nn.Parameter(torch.zeros(full, dtype=pdt, device=device))
            if init == "embed":
                return nn.Parameter(embed_init(generator, full, pdt, device=device))
            return nn.Parameter(dense_init(generator, shape, pdt, layers=layers, device=device))

        self.embed = make((v, d), "embed")
        self.final_norm = make((d,), "zeros")
        self.out = None if cfg.tie_embeddings else make((v, d), "dense")
        self.layers = nn.ParameterDict({
            name: make(shape, "zeros" if name in _ZERO_INIT else "dense", layers=n)
            for name, shape in layer_shapes(cfg).items()
        })

    def state_tree(self) -> Dict[str, Any]:
        """The reference's parameter tree; its leaves are this module's
        own parameters (not copies)."""
        tree: Dict[str, Any] = {
            "embed": self.embed,
            "final_norm": self.final_norm,
            "layers": dict(self.layers.items()),
        }
        if self.out is not None:
            tree["out"] = self.out
        return tree

    def forward(self, tokens: torch.Tensor, *, chunk_q: Optional[int] = -1,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self.state_tree(), self.cfg, tokens, chunk_q=chunk_q, remat=remat)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _qkv(p, cfg: ModelConfig, x, positions):
    """Projections of ``x`` (B, S, d) with RoPE at ``positions``:
    q (B, S, H, hd), k and v (B, S, H_kv, hd)."""
    b, s, d = x.shape
    hd = cfg.hd
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p, cfg: ModelConfig, o):
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(o.dtype)


def _mlp(p, cfg: ModelConfig, x):
    """The residual MLP half of a block: ``x + swiglu(rms_norm(x))``."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _block_kv(p, cfg: ModelConfig, x, positions, *, chunk_q):
    """One block; also returns its keys and values (B, S, H_kv, hd)."""
    q, k, v = _qkv(p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions)
    o = attention(q, k, v, causal=True, window=cfg.window, chunk_q=chunk_q)
    return _mlp(p, cfg, x + _out(p, cfg, o)), k, v


def block(p, cfg: ModelConfig, x, positions, *, chunk_q=1024):
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    return _block_kv(p, cfg, x, positions, chunk_q=chunk_q)[0]


def embed_inputs(params, cfg: ModelConfig, tokens, patches=None):
    if patches is not None:
        raise NotImplementedError(VLM_TODO)
    return params["embed"].to(cfg.cdt)[tokens.long()]


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patches: Optional[torch.Tensor] = None,
    chunk_q: Optional[int] = -1,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux loss ())."""
    if chunk_q == -1:
        chunk_q = cfg.chunk_q
    x = embed_inputs(params, cfg, tokens, patches)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    names = list(params["layers"])
    slices = [params["layers"][n].unbind(0) for n in names]

    def body(h, *lp):
        return block(dict(zip(names, lp)), cfg, h, positions, chunk_q=chunk_q)

    for lp in zip(*slices):
        if remat:
            x = checkpoint(body, x, *lp, use_reentrant=False)
        else:
            x = body(x, *lp)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def _layers(params):
    """Each layer's parameters as a dict of slices of the stacks (one
    ``unbind`` a name)."""
    names = list(params["layers"])
    for lp in zip(*(params["layers"][n].unbind(0) for n in names)):
        yield dict(zip(names, lp))


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_w = params.get("out", params["embed"])
    return x @ out_w.to(cfg.cdt).T


def lm_loss(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patches: Optional[torch.Tensor] = None,
    chunk_q: Optional[int] = -1,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.

    The gold logit comes from ``gather``: a sum of one value and zeros
    is exact, so it equals the reference's mask-and-reduce without its
    (B, S, V) mask."""
    logits, aux = forward(params, cfg, tokens, patches=patches, chunk_q=chunk_q, remat=remat)
    pred = logits[:, : tokens.shape[1] - 1]
    tgt = tokens[:, 1:].long()
    lf = pred.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, tgt[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    k: torch.Tensor     # (L, B, S_max, H_kv, hd), compute dtype
    v: torch.Tensor
    pos: torch.Tensor   # () int32


def init_cache(cfg: ModelConfig, b: int, s_max: int, device=None) -> DecodeCache:
    shape = (cfg.n_layers, b, s_max, cfg.n_kv_heads, cfg.hd)
    return DecodeCache(
        k=torch.zeros(shape, dtype=cfg.cdt, device=device),
        v=torch.zeros(shape, dtype=cfg.cdt, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def prefill(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patches: Optional[torch.Tensor] = None,
    s_max: Optional[int] = None,
    chunk_q: Optional[int] = -1,
) -> Tuple[DecodeCache, torch.Tensor]:
    """Run the prompt, build the KV cache, return logits of the last token."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    if chunk_q == -1:
        chunk_q = cfg.chunk_q
    x = embed_inputs(params, cfg, tokens, patches)
    b, s, _ = x.shape
    s_max = max(s_max or s, s)  # cache must hold the whole prompt
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, s_max, device=x.device)
    for layer, p in enumerate(_layers(params)):
        x, k, v = _block_kv(p, cfg, x, positions, chunk_q=chunk_q)
        cache.k[layer, :, :s] = k
        cache.v[layer, :, :s] = v
    logits = _logits(params, cfg, x[:, -1])
    return cache._replace(pos=torch.tensor(s, dtype=torch.int32, device=x.device)), logits


def decode_step(
    params, cfg: ModelConfig, cache: DecodeCache, tokens: torch.Tensor
) -> Tuple[torch.Tensor, DecodeCache]:
    """tokens: (B, 1) -> (logits (B, V), updated cache); ``cache`` is
    left unchanged."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    x = embed_inputs(params, cfg, tokens)                  # (B, 1, d)
    positions = cache.pos + torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    pos = cache.pos + 1
    ks, vs = cache.k.clone(), cache.v.clone()              # the new cache
    for layer, p in enumerate(_layers(params)):
        q, k, v = _qkv(p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions)
        write_at_(ks[layer], k, cache.pos)
        write_at_(vs[layer], v, cache.pos)
        o = decode_attention(q, KVCache(ks[layer], vs[layer], pos), window=cfg.window)
        x = _mlp(p, cfg, x + _out(p, cfg, o))
    return _logits(params, cfg, x[:, 0]), DecodeCache(k=ks, v=vs, pos=pos)
