"""Whisper-style encoder-decoder (arXiv:2212.04356), backbone only.

Counterpart of ``repro/models/whisper.py``, op for op. The
mel-spectrogram/conv frontend is a stub, as in the reference: a batch
carries precomputed frame embeddings ``frames`` (B, enc_seq, d_model).
The encoder adds the fixed sinusoidal table ``enc_pos`` (a trainable
parameter, as the reference's init makes it) and runs pre-LayerNorm
blocks with biases and GELU MLPs; the decoder adds analytic sinusoidal
positions to the tied token embedding and runs causal self-attention,
cross-attention over the encoder's memory and the MLP. Attention has no
key bias (``wq/bq``, ``wk``, ``wv/bv``, ``wo/bo``).

Parameters keep the reference's layout: :meth:`Whisper.state_tree` is
the nested dict of its init (``enc_pos``, stacked ``enc_layers``,
``enc_ln_s/b``, ``embed``, stacked ``dec_layers`` with ``self``,
``cross`` and ``lnx_s/b``, ``dec_ln_s/b``), so train states cross
between the packages. Each stack is ``unbind``\\ ed once a pass, as in
:mod:`.transformer`. The encoder is always recomputed in backward (the
reference wraps its body in ``jax.checkpoint``); ``remat`` does the same
for the decoder's blocks.

Serving: :class:`WhisperCache` holds the decoder's self-attention K/V
(padded to ``s_max``), the cross-attention K/V computed once from the
encoder's memory by :func:`init_cache`, and ``pos``. ``decode_step``
attends to every memory key (``decode_attention`` with ``pos`` =
enc_seq), writes the new self K/V into clones and returns a new cache
that shares the static cross K/V; the given cache stays valid, and a
step reads nothing back to the host. ``pad_heads_for_tp`` (12 heads
pad to 16 under 16-way TP) and the ``shard_act`` pins sit where the
reference has them; they are no-ops without a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    KVCache, attention, decode_attention, pad_heads_for_tp, write_at_,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cross_entropy,
    gelu_mlp,
    layer_norm,
    new_param,
    sinusoidal_positions,
    sinusoidal_positions_at,
)
from repro_torch.models.sharding import shard_act
from repro_torch.models.transformer import _layer_slices, _layers
from repro_torch.utils.treelib import unflatten


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    q_dim = cfg.n_heads * cfg.hd
    kv_dim = cfg.n_kv_heads * cfg.hd
    return {"wq": (d, q_dim), "bq": (q_dim,), "wk": (d, kv_dim), "wv": (d, kv_dim),
            "bv": (kv_dim,), "wo": (q_dim, d), "bo": (d,)}


def layer_shapes(cfg: ModelConfig, *, decoder: bool) -> Dict[str, Any]:
    """Per-layer shape of every stacked parameter of an encoder or a
    decoder block; the attentions' are nested under ``self`` (and
    ``cross``)."""
    d, ff = cfg.d_model, cfg.d_ff
    shapes: Dict[str, Any] = {
        "ln1_s": (d,), "ln1_b": (d,), "self": _attn_shapes(cfg),
        "ln2_s": (d,), "ln2_b": (d,),
        "w_in": (d, ff), "b_in": (ff,), "w_out": (ff, d), "b_out": (d,)}
    if decoder:
        shapes.update(lnx_s=(d,), lnx_b=(d,), cross=_attn_shapes(cfg))
    return shapes


def _init_of(name: str):
    """LayerNorm scales start at 1, biases at 0, matrices dense."""
    if name.endswith("_s"):
        return 1.0
    if name.startswith("b") or name.endswith("_b"):
        return 0.0
    return "dense"


def _stacks(cfg: ModelConfig, n: int, generator, device, *, decoder: bool) -> nn.ModuleDict:
    """A block's stacks ``n`` deep: the flat ones under ``"layer"``, each
    attention's under its name."""
    def params(shapes):
        return nn.ParameterDict({
            name: new_param(generator, shape, cfg.pdt, device, _init_of(name), layers=n)
            for name, shape in shapes.items()})

    shapes = layer_shapes(cfg, decoder=decoder)
    nested = {k: shapes.pop(k) for k in [k for k, v in shapes.items() if isinstance(v, dict)]}
    return nn.ModuleDict({"layer": params(shapes), **{k: params(v) for k, v in nested.items()}})


def _stack_tree(stacks: nn.ModuleDict) -> Dict[str, Any]:
    tree: Dict[str, Any] = dict(stacks["layer"].items())
    tree.update({k: dict(m.items()) for k, m in stacks.items() if k != "layer"})
    return tree


class Whisper(nn.Module):
    """whisper's parameters: the encoder's and the decoder's stacks, the
    positional table, the tied embedding and the final norms.

    With a ``generator`` they are initialised as the reference
    initialises them (``enc_pos`` the sinusoidal table itself); without
    one they are left uninitialised (``torch.empty``), to be loaded."""

    def __init__(self, cfg: ModelConfig, *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model

        def make(shape, init):
            return new_param(generator, shape, cfg.pdt, device, init)

        self.enc_layers = _stacks(cfg, cfg.n_enc_layers, generator, device, decoder=False)
        self.dec_layers = _stacks(cfg, cfg.n_layers, generator, device, decoder=True)
        self.enc_pos = make((cfg.enc_seq, d),
                            torch.from_numpy(sinusoidal_positions(cfg.enc_seq, d)))
        self.enc_ln_s, self.enc_ln_b = make((d,), 1.0), make((d,), 0.0)
        self.embed = make((cfg.vocab_size, d), "embed")
        self.dec_ln_s, self.dec_ln_b = make((d,), 1.0), make((d,), 0.0)

    def state_tree(self) -> Dict[str, Any]:
        """The reference's parameter tree; its leaves are this module's
        own parameters (not copies)."""
        return {
            "enc_pos": self.enc_pos,
            "enc_layers": _stack_tree(self.enc_layers),
            "enc_ln_s": self.enc_ln_s, "enc_ln_b": self.enc_ln_b,
            "embed": self.embed,
            "dec_layers": _stack_tree(self.dec_layers),
            "dec_ln_s": self.dec_ln_s, "dec_ln_b": self.dec_ln_b,
        }

    def forward(self, tokens: torch.Tensor, *, frames: torch.Tensor, remat: bool = False):
        return forward(self.state_tree(), self.cfg, tokens, frames=frames, remat=remat)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _q(p, cfg: ModelConfig, x):
    """Queries of ``x`` (B, S, d): (B, S, H, hd)."""
    dt = x.dtype
    return (x @ p["wq"].to(dt) + p["bq"].to(dt)).reshape(*x.shape[:2], cfg.n_heads, cfg.hd)


def _kv(p, cfg: ModelConfig, x):
    """Keys (no bias) and values of ``x`` (B, S, d): each (B, S, H_kv, hd)."""
    dt = x.dtype
    shape = (*x.shape[:2], cfg.n_kv_heads, cfg.hd)
    return ((x @ p["wk"].to(dt)).reshape(shape),
            (x @ p["wv"].to(dt) + p["bv"].to(dt)).reshape(shape))


def _mha(p, cfg: ModelConfig, xq, xkv, *, causal: bool, chunk_q=1024):
    """Attention of ``xq`` over ``xkv``: (output (B, Sq, d), k, v), k and
    v (B, Skv, H_kv, hd) in the compute dtype."""
    k, v = _kv(p, cfg, xkv)
    qp, kp, vp, n_h = pad_heads_for_tp(_q(p, cfg, xq), k, v)
    qp = shard_act(qp, "dp", None, "tp", None)
    o = attention(qp, kp, vp, causal=causal, chunk_q=chunk_q)[:, :, :n_h]
    return _out(p, cfg, o), k, v


def _out(p, cfg: ModelConfig, o):
    b, s = o.shape[:2]
    dt = o.dtype
    return o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(dt) + p["bo"].to(dt)


def _mlp(p, cfg: ModelConfig, h):
    return h + gelu_mlp(layer_norm(h, p["ln2_s"], p["ln2_b"], cfg.norm_eps),
                        p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _enc_block(p, cfg: ModelConfig, h):
    hn = layer_norm(h, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    a, _, _ = _mha(p["self"], cfg, hn, hn, causal=False)
    return _mlp(p, cfg, h + a)


def _dec_block_kv(p, cfg: ModelConfig, h, memory):
    """One decoder block: (h, the self-attention's k and v)."""
    hn = layer_norm(h, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    a, k, v = _mha(p["self"], cfg, hn, hn, causal=True)
    h = h + a
    c, _, _ = _mha(p["cross"], cfg, layer_norm(h, p["lnx_s"], p["lnx_b"], cfg.norm_eps),
                   memory, causal=False)
    return _mlp(p, cfg, h + c), k, v


def _run_stack(params, key: str, x, block, *, remat: bool, extra=()):
    """``x`` through the stack ``params[key]``, one ``block(p, x,
    *extra)`` a layer; with ``remat`` (and grad on) each recomputed in
    backward."""
    treedef, per_layer = _layer_slices(params, key)

    def body(h, *args):
        return block(unflatten(treedef, list(args[len(extra):])), h, *args[:len(extra)])

    remat = remat and torch.is_grad_enabled()
    for lp in per_layer:
        x = checkpoint(body, x, *extra, *lp, use_reentrant=False) if remat else body(x, *extra, *lp)
    return x


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub embeddings -> encoder memory, in the
    compute dtype. Always rematerialised in backward, as the reference."""
    x = frames.to(cfg.cdt) + params["enc_pos"].to(cfg.cdt)[None]
    x = _run_stack(params, "enc_layers", x, lambda p, h: _enc_block(p, cfg, h), remat=True)
    return layer_norm(x, params["enc_ln_s"], params["enc_ln_b"], cfg.norm_eps)


def _embed(params, cfg: ModelConfig, tokens, positions):
    x = params["embed"].to(cfg.cdt)[tokens.long()]
    return x + sinusoidal_positions_at(positions, cfg.d_model).to(cfg.cdt)[None]


def _logits(params, cfg: ModelConfig, x):
    x = layer_norm(x, params["dec_ln_s"], params["dec_ln_b"], cfg.norm_eps)
    return x @ params["embed"].to(cfg.cdt).T                        # tied


def decode_train(params, cfg: ModelConfig, tokens, memory, *, remat: bool = True):
    x = _embed(params, cfg, tokens, torch.arange(tokens.shape[1], device=tokens.device))
    x = _run_stack(params, "dec_layers", x, lambda p, h, m: _dec_block_kv(p, cfg, h, m)[0],
                   remat=remat, extra=(memory,))
    return _logits(params, cfg, x)


def forward(params, cfg: ModelConfig, tokens, *, frames=None, remat: bool = True, **_):
    """-> (logits (B, S, V), a zero aux loss () float32)."""
    logits = decode_train(params, cfg, tokens, encode(params, cfg, frames), remat=remat)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(params, cfg: ModelConfig, tokens, *, frames=None, remat: bool = True, **_):
    logits, aux = forward(params, cfg, tokens, frames=frames, remat=remat)
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class WhisperCache(NamedTuple):
    k: torch.Tensor      # (L, B, S_max, H_kv, hd) decoder self-attn, compute dtype
    v: torch.Tensor
    xk: torch.Tensor     # (L, B, enc_seq, H_kv, hd) cross K (static)
    xv: torch.Tensor
    pos: torch.Tensor    # () int32


def cache_zeros(cfg: ModelConfig, b: int, s_max: int, device=None) -> WhisperCache:
    """A zero cache on ``device``, the cross K/V zero too (on the meta
    device: the structure a snapshot restores into)."""
    def z(s):
        return torch.zeros((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd), dtype=cfg.cdt,
                           device=device)

    return WhisperCache(k=z(s_max), v=z(s_max), xk=z(cfg.enc_seq), xv=z(cfg.enc_seq),
                        pos=torch.zeros((), dtype=torch.int32, device=device))


def init_cache(params, cfg: ModelConfig, memory, b: int, s_max: int) -> WhisperCache:
    """The cross K/V from the encoder's ``memory`` (B, enc_seq, d);
    an empty self cache."""
    xk, xv = zip(*(_kv(lp["cross"], cfg, memory) for lp in _layers(params, "dec_layers")))
    empty = cache_zeros(cfg, b, s_max, device=memory.device)
    return empty._replace(xk=torch.stack(xk), xv=torch.stack(xv))


def decode_step(params, cfg: ModelConfig, cache: WhisperCache, tokens):
    """tokens: (B, 1) -> (logits (B, V), the next cache); ``cache`` is
    left unchanged (its cross K/V are shared, never written)."""
    x = _embed(params, cfg, tokens, cache.pos[None])
    pos = cache.pos + 1
    # every memory key is visible to the one new token
    enc_pos = torch.full((), cache.xk.shape[2], dtype=torch.int32, device=x.device)
    ks, vs = cache.k.clone(), cache.v.clone()
    for layer, lp in enumerate(_layers(params, "dec_layers")):
        sp, cp = lp["self"], lp["cross"]
        hn = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        k, v = _kv(sp, cfg, hn)
        write_at_(ks[layer], k, cache.pos)
        write_at_(vs[layer], v, cache.pos)
        o = decode_attention(_q(sp, cfg, hn), KVCache(ks[layer], vs[layer], pos))
        x = x + _out(sp, cfg, o)
        hx = layer_norm(x, lp["lnx_s"], lp["lnx_b"], cfg.norm_eps)
        xc = KVCache(cache.xk[layer], cache.xv[layer], enc_pos)
        x = _mlp(lp, cfg, x + _out(cp, cfg, decode_attention(_q(cp, cfg, hx), xc)))
    return _logits(params, cfg, x[:, 0]), cache._replace(k=ks, v=vs, pos=pos)


def prefill(params, cfg: ModelConfig, tokens, *, frames=None, s_max: Optional[int] = None,
            **_) -> Tuple[WhisperCache, torch.Tensor]:
    """Encode ``frames``, then one teacher-forced decoder pass over the
    prompt that collects the self-attention K/V (padded to ``s_max`` in
    the compute dtype) -> (cache, logits of the last token)."""
    memory = encode(params, cfg, frames)
    b, s = tokens.shape
    s_max = max(s_max or s, s)
    x = _embed(params, cfg, tokens, torch.arange(s, device=tokens.device))
    cache = init_cache(params, cfg, memory, b, s_max)
    for layer, lp in enumerate(_layers(params, "dec_layers")):
        x, k, v = _dec_block_kv(lp, cfg, x, memory)
        cache.k[layer, :, :s] = shard_act(k.to(cfg.cdt), "dp", None, None, "tp")
        cache.v[layer, :, :s] = shard_act(v.to(cfg.cdt), "dp", None, None, "tp")
    logits = _logits(params, cfg, x[:, -1])
    return cache._replace(pos=torch.tensor(s, dtype=torch.int32, device=x.device)), logits
