"""Shared neural building blocks on torch tensors.

Counterpart of ``repro/models/layers.py``: the numerics follow the
reference op for op (float32 inside the norms, the rotary embedding,
the SiLU and the GELU; casts back to the compute dtype where the
reference casts). ``_act_ff`` is the reference's sharding pin on the
MLPs' wide intermediates (:func:`~repro_torch.models.sharding.shard_act`:
a no-op without a mesh). ``new_param`` and
``cross_entropy`` are the port's own: the families share them where the
reference repeats the same lines in each.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import shard_act


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)    # jnp.var: population
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Half-split ("NeoX") rotation in float32, as the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Analytic sinusoidal embeddings (..., d_model) float32 at
    ``positions`` (any shape), computed in float32 as the reference."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=positions.device)
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    inv = torch.exp(-log_base * dim / max(1, d_model // 2 - 1))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n_pos: int, d_model: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal position embedding table."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / max(1, d_model // 2 - 1))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _act_ff(h: torch.Tensor) -> torch.Tensor:
    """Pin wide MLP intermediates: batch over dp, feature over tp."""
    kinds = ("dp",) + (None,) * (h.ndim - 2) + ("tp",)
    return shard_act(h, *kinds)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = _act_ff(x @ w_gate.to(x.dtype))
    u = _act_ff(x @ w_up.to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_in, b_in, w_out, b_out) -> torch.Tensor:
    h = x @ w_in.to(x.dtype) + b_in.to(x.dtype)
    h = _act_ff(h)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_out.to(x.dtype) + b_out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (all take an explicit generator)
# ---------------------------------------------------------------------------


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator`` (on the
    generator's own device), placed on ``device``."""
    return torch.randn(
        shape, generator=generator, dtype=torch.float32, device=generator.device
    ).to(device)


def dense_init(
    generator: torch.Generator,
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    *,
    scale: Optional[float] = None,
    layers: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """N(0, 1/fan_in) of ``shape`` (fan_in: the product of all but the
    last dim), or ``scale`` as the std. ``layers`` stacks that many
    independent draws on a leading axis; the fan-in is that of one."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else max(1, shape[0])
    std = scale if scale is not None else (1.0 / np.sqrt(fan_in))
    full = shape if layers is None else (layers, *shape)
    return (_normal(generator, full, device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype, *, device=None) -> torch.Tensor:
    return (_normal(generator, shape, device) * 0.02).to(dtype)


def new_param(generator: Optional[torch.Generator], shape, dtype, device, init="dense", *,
              scale: Optional[float] = None, layers: Optional[int] = None) -> nn.Parameter:
    """A parameter of ``shape`` (stacked ``layers`` deep when given):
    ``init`` is ``"dense"`` (``dense_init`` with ``scale``), ``"embed"``,
    a number (every element that value) or a tensor (its values). Without
    a ``generator`` it is left uninitialised (``torch.empty``), to be
    loaded."""
    full = shape if layers is None else (layers, *shape)
    if generator is None:
        return nn.Parameter(torch.empty(full, dtype=dtype, device=device))
    if init == "dense":
        t = dense_init(generator, shape, dtype, scale=scale, layers=layers, device=device)
    elif init == "embed":
        t = embed_init(generator, full, dtype, device=device)
    elif isinstance(init, torch.Tensor):
        t = init.to(dtype=dtype, device=device)
    else:
        t = torch.full(full, float(init), dtype=dtype, device=device)
    return nn.Parameter(t)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 of ``logits`` (..., V)
    against ``targets`` (...). The gold logit comes from ``gather``: a
    sum of one value and zeros is exact, so it equals the reference's
    mask-and-reduce without its (..., V) mask."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def causal_mask(s_q: int, s_k: int, *, q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_k) boolean mask; True = attend."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    return ki <= qi


def window_mask(
    s_q: int, s_k: int, window: int, *, q_offset: int = 0, device=None
) -> torch.Tensor:
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    return (ki <= qi) & (ki > qi - window)
