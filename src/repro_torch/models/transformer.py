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

Not ported yet: the MoE FFN and VLM patches (ROADMAP Queue 1 item 7),
``prefill``/``decode_step`` (item 5).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, embed_init, rms_norm, swiglu

MOE_TODO = "the MoE FFN is not ported yet (ROADMAP Queue 1 item 7)"
VLM_TODO = "VLM patch inputs are not ported yet (ROADMAP Queue 1 item 7)"
SERVE_TODO = "prefill/decode are not ported yet (ROADMAP Queue 1 item 5, serving)"


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


def _attn(p, cfg: ModelConfig, x, positions, *, chunk_q):
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
    o = attention(q, k, v, causal=True, window=cfg.window, chunk_q=chunk_q)
    out = o.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(dt)
    return out, k, v


def block(p, cfg: ModelConfig, x, positions, *, chunk_q=1024):
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)
    o, _, _ = _attn(p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions, chunk_q=chunk_q)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x + f


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
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_w = params.get("out", params["embed"])
    logits = x @ out_w.to(cfg.cdt).T
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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


def prefill(*args, **kwargs):
    raise NotImplementedError(SERVE_TODO)


def decode_step(*args, **kwargs):
    raise NotImplementedError(SERVE_TODO)
