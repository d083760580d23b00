"""Decoder-only transformer LM: dense (llama/qwen style), MoE, and VLM.

Counterpart of ``repro/models/transformer.py``: pre-RMSNorm, GQA
attention with RoPE, SwiGLU MLP or the MoE FFN (:mod:`.moe`). VLM
(LLaVA-style): precomputed patch embeddings (a stub frontend) are
prepended to the token embeddings, and the loss skips their positions.
Parameters keep the reference's layout: one tensor per name, stacked
over layers (``layers.wq`` is ``(L, d, q_dim)``; the MoE FFN's under
``layers.moe``, its router float32 whatever the parameter dtype), so
:meth:`Transformer.state_tree` is the nested dict the JAX init gives,
with the same keys, shapes and dtypes, and a train checkpoint of either
package restores in the other.

The forward pass ``unbind``\\ s each stack once, nested ones included
(backward is then one ``stack`` a name, where indexing ``w[l]`` in each
layer would make autograd build a full zero stack per layer) and casts
each layer's slice to the compute dtype inside the block, as the
reference does inside its scan. ``remat`` recomputes each block in
backward (``torch.utils.checkpoint``). The MoE blocks' aux losses are
summed over the layers, as the reference's scan carry sums them.

Serving: ``prefill`` runs the prompt through the same attention paths
as ``forward`` (unchunked, or query-chunked past ``chunk_q``) and fills
a ``DecodeCache`` padded to ``s_max``; ``decode_step`` feeds one token a
sequence through the same pieces (``rms_norm``, RoPE at ``cache.pos``,
``swiglu``) against the cache. The cache is stored in the compute
dtype. ``decode_step`` returns a new cache, as the reference's scan
does: it clones the given cache once a step and writes each layer's new
key and value into the clone, so the cache it was given stays valid.
As in the reference, ``prefill`` and ``decode_step`` route with the
capacity of their own sequence length (the prompt's, patches included;
4 in decode), so prefill drops tokens by capacity as training does.

The reference's sharding pins (``shard_act``, ``pad_heads_for_tp``) sit
where it has them; they change nothing without an
``activation_sharding`` mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    KVCache, attention, decode_attention, pad_heads_for_tp, write_at_,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, cross_entropy, new_param, rms_norm, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.sharding import shard_act
from repro_torch.utils.treelib import flatten_with_names, unflatten


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def layer_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Per-layer shape of every stacked parameter, in the reference's
    order of initialisation; the MoE FFN's are nested under ``"moe"``."""
    d, hd = cfg.d_model, cfg.hd
    q_dim = cfg.n_heads * hd
    kv_dim = cfg.n_kv_heads * hd
    shapes: Dict[str, Any] = {
        "wq": (d, q_dim), "wk": (d, kv_dim), "wv": (d, kv_dim), "wo": (q_dim, d),
        "ln1": (d,), "ln2": (d,)}
    if cfg.qkv_bias:
        shapes.update(bq=(q_dim,), bk=(kv_dim,), bv=(kv_dim,))
    if cfg.moe is not None:
        m = cfg.moe
        e_ff = m.expert_d_ff or cfg.d_ff
        moe = {"router": (d, m.n_experts), "w_gate": (m.n_experts, d, e_ff),
               "w_up": (m.n_experts, d, e_ff), "w_down": (m.n_experts, e_ff, d)}
        if m.n_shared:
            sh_ff = m.shared_d_ff or m.n_shared * e_ff
            moe.update(shared_gate=(d, sh_ff), shared_up=(d, sh_ff), shared_down=(sh_ff, d))
        shapes["moe"] = moe
    else:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
    return shapes


_ZERO_INIT = ("ln1", "ln2", "bq", "bk", "bv")
# the router stays float32 whatever the parameter dtype (reference
# init_layer), so its AdamW moments are float32 too
_FLOAT32_LEAVES = ("router",)


class Transformer(nn.Module):
    """The decoder's parameters, stacked over layers.

    With a ``generator`` the parameters are initialised as the
    reference initialises them (normal draws, from the generator's
    device, then placed on ``device``); without one they are left
    uninitialised (``torch.empty``), to be loaded. The MoE FFN's stacks
    are the module's ``moe`` (``None`` for a dense FFN); ``state_tree``
    nests them under ``layers`` as the reference does.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        v, d, n = cfg.vocab_size, cfg.d_model, cfg.n_layers

        def make(shape, init, *, layers=None, dtype=cfg.pdt):
            return new_param(generator, shape, dtype, device, init, layers=layers)

        def stacks(shapes):
            return nn.ParameterDict({
                name: make(shape, 0.0 if name in _ZERO_INIT else "dense", layers=n,
                           dtype=torch.float32 if name in _FLOAT32_LEAVES else cfg.pdt)
                for name, shape in shapes.items()
            })

        self.embed = make((v, d), "embed")
        self.final_norm = make((d,), 0.0)
        self.out = None if cfg.tie_embeddings else make((v, d), "dense")
        shapes = layer_shapes(cfg)
        moe = shapes.pop("moe", None)
        self.layers = stacks(shapes)
        self.moe = None if moe is None else stacks(moe)

    def state_tree(self) -> Dict[str, Any]:
        """The reference's parameter tree; its leaves are this module's
        own parameters (not copies)."""
        layers: Dict[str, Any] = dict(self.layers.items())
        if self.moe is not None:
            layers["moe"] = dict(self.moe.items())
        tree: Dict[str, Any] = {
            "embed": self.embed,
            "final_norm": self.final_norm,
            "layers": layers,
        }
        if self.out is not None:
            tree["out"] = self.out
        return tree

    def forward(self, tokens: torch.Tensor, *, patches: Optional[torch.Tensor] = None,
                chunk_q: Optional[int] = -1,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self.state_tree(), self.cfg, tokens, patches=patches, chunk_q=chunk_q,
                       remat=remat)


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


def _attend(cfg: ModelConfig, q, k, v, *, chunk_q):
    """Causal attention of the block's heads, padded to the TP degree
    and pinned as the reference pins them."""
    qp, kp, vp, n_h = pad_heads_for_tp(q, k, v)
    qp = shard_act(qp, "dp", None, "tp", None)
    kp = shard_act(kp, "dp", None, "tp", None)
    vp = shard_act(vp, "dp", None, "tp", None)
    o = attention(qp, kp, vp, causal=True, window=cfg.window, chunk_q=chunk_q)
    return shard_act(o, "dp", None, "tp", None)[:, :, :n_h]


def _out(p, cfg: ModelConfig, o):
    b, s = o.shape[:2]
    out = o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(o.dtype)
    return shard_act(out, "dp", None, None)


def _ffn(p, cfg: ModelConfig, x):
    """The residual FFN half of a block: ``x + ffn(rms_norm(x))``, and
    the MoE FFN's aux loss (``None`` for a dense FFN)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        f, aux = moe_ffn(h, p["moe"], cfg.moe)
        return x + f, aux
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None


def _block_kv(p, cfg: ModelConfig, x, positions, *, chunk_q):
    """One block: ``(x, aux, k, v)`` with its keys and values
    (B, S, H_kv, hd)."""
    q, k, v = _qkv(p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions)
    o = _attend(cfg, q, k, v, chunk_q=chunk_q)
    x, aux = _ffn(p, cfg, x + _out(p, cfg, o))
    return x, aux, k, v


def block(p, cfg: ModelConfig, x, positions, *, chunk_q=1024):
    """One block: ``(x, aux)``; aux is ``None`` for a dense FFN (the
    reference's zero, which adds nothing)."""
    return _block_kv(p, cfg, x, positions, chunk_q=chunk_q)[:2]


def embed_inputs(params, cfg: ModelConfig, tokens, patches=None):
    x = shard_act(params["embed"].to(cfg.cdt)[tokens.long()], "dp", None, None)
    if patches is not None:
        pe = shard_act(patches.to(cfg.cdt), "dp", None, None)
        x = torch.cat([pe, x], dim=1)
    return x


def _layer_slices(params, key: str = "layers") -> Tuple[Any, List[Tuple[torch.Tensor, ...]]]:
    """The treedef of ``params[key]`` (nested stacks included) and, per
    layer, the tuple of its stacks' slices: one ``unbind`` a stack."""
    named, treedef = flatten_with_names(params[key])
    return treedef, list(zip(*(w.unbind(0) for _, w in named)))


def _layers(params, key: str = "layers") -> Iterator[Dict[str, Any]]:
    """Each layer's parameters as a dict (nested as ``params[key]`` is)
    of slices of the stacks."""
    treedef, per_layer = _layer_slices(params, key)
    for lp in per_layer:
        yield unflatten(treedef, list(lp))


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patches: Optional[torch.Tensor] = None,
    chunk_q: Optional[int] = -1,
    remat: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux loss () float32)."""
    if chunk_q == -1:
        chunk_q = cfg.chunk_q
    x = embed_inputs(params, cfg, tokens, patches)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    treedef, per_layer = _layer_slices(params)
    # sequence parallelism on the carried residual stream (the
    # reference's rule): worth its per-layer seq re-gathers only for wide
    # models
    sp_axis = "tp" if cfg.d_model >= 4096 else None

    def body(h, *lp):
        return block(unflatten(treedef, list(lp)), cfg, h, positions, chunk_q=chunk_q)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in per_layer:
        if remat:
            x, a = checkpoint(body, x, *lp, use_reentrant=False)
        else:
            x, a = body(x, *lp)
        x = shard_act(x, "dp", sp_axis, None)
        if a is not None:
            aux = aux + a
    return shard_act(_logits(params, cfg, x), "dp", None, "tp"), aux


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
    """Next-token cross-entropy (patch prefix positions excluded)."""
    logits, aux = forward(params, cfg, tokens, patches=patches, chunk_q=chunk_q, remat=remat)
    n_prefix = 0 if patches is None else patches.shape[1]
    # predict tokens[t+1] from position n_prefix + t
    ce = cross_entropy(logits[:, n_prefix : n_prefix + tokens.shape[1] - 1], tokens[:, 1:])
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
    """Run the prompt (patches first), build the KV cache, return
    logits of the last token."""
    if chunk_q == -1:
        chunk_q = cfg.chunk_q
    x = embed_inputs(params, cfg, tokens, patches)
    b, s, _ = x.shape
    s_max = max(s_max or s, s)  # cache must hold the whole prompt
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, s_max, device=x.device)
    for layer, p in enumerate(_layers(params)):
        x, _, k, v = _block_kv(p, cfg, x, positions, chunk_q=chunk_q)
        x = shard_act(x, "dp", "tp", None)
        # cache layout matches decode cache_specs: head_dim over "model"
        cache.k[layer, :, :s] = shard_act(k.to(cfg.cdt), "dp", None, None, "tp")
        cache.v[layer, :, :s] = shard_act(v.to(cfg.cdt), "dp", None, None, "tp")
    logits = _logits(params, cfg, x[:, -1])
    return cache._replace(pos=torch.tensor(s, dtype=torch.int32, device=x.device)), logits


def decode_step(
    params, cfg: ModelConfig, cache: DecodeCache, tokens: torch.Tensor
) -> Tuple[torch.Tensor, DecodeCache]:
    """tokens: (B, 1) -> (logits (B, V), updated cache); ``cache`` is
    left unchanged."""
    x = embed_inputs(params, cfg, tokens)                  # (B, 1, d)
    positions = cache.pos + torch.zeros((1, 1), dtype=torch.int32, device=x.device)
    pos = cache.pos + 1
    ks, vs = cache.k.clone(), cache.v.clone()              # the new cache
    for layer, p in enumerate(_layers(params)):
        q, k, v = _qkv(p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions)
        write_at_(ks[layer], k, cache.pos)
        write_at_(vs[layer], v, cache.pos)
        o = decode_attention(q, KVCache(ks[layer], vs[layer], pos), window=cfg.window)
        x, _ = _ffn(p, cfg, x + _out(p, cfg, o))
    return _logits(params, cfg, x[:, 0]), DecodeCache(k=ks, v=vs, pos=pos)
