"""The reference's training steps: AdamW (decoupled weight decay) with
global-norm clipping, bias corrections and a linear warm-up into a
cosine schedule, in float32, after Loshchilov and Hutter
(arXiv:1711.05101).

``train_steps`` runs a model's loss through ``len(batches)`` steps from
the given parameters and returns what the correctness check compares
(:class:`Readings`). The gradient a step hands the optimizer is the
clipped one; its norm is read back from the first moment after the
first step (``mu / (1 - beta1)``), as it is read from the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from ckpt_bench.reference.ops import no_tf32
from ckpt_bench.tree import flatten


@dataclass
class Readings:
    """One side's numbers: the loss of each step, each leaf's first
    gradient as the optimizer got it (float32; the program's on the host)
    and its norm, the first step's global gradient norm before the clip
    and the factor by which the clip divided the gradient (1 where it
    did not act), and each leaf's norm of the parameters' change over
    the steps."""

    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    first_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    global_norm: float = float("nan")
    unclip: float = 1.0
    change_norms: Dict[str, float] = field(default_factory=dict)


def lr_at(opt: Dict[str, Any], count: int) -> float:
    warm = min((count + 1) / max(1, opt["warmup_steps"]), 1.0)
    t = min(max((count - opt["warmup_steps"]) / max(1, opt["total_steps"] - opt["warmup_steps"]),
                0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def unclip_factor(global_norm: float, clip: float) -> float:
    """The factor by which a clip to ``clip`` divided a gradient of
    ``global_norm``."""
    return global_norm / clip if global_norm > clip else 1.0


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def train_steps(model: Any, cfg: Dict[str, Any], params: Any, batches: List[Dict[str, Any]],
                opt: Dict[str, Any], *, precision: str = "float32", rows=None) -> Readings:
    """``model`` is a reference module (``loss``); ``params`` its tree of
    float32 leaves (left unchanged). ``rows``: the loss over the first
    ``rows`` rows of each batch only (a fault of the checks' tests)."""
    named = flatten(params)
    names = [n for n, _ in named]
    start = [t.detach() for _, t in named]
    p = [t.detach().clone().requires_grad_(True) for t in start]
    mu = [torch.zeros_like(t) for t in start]
    nu = [torch.zeros_like(t) for t in start]
    b1, b2 = opt["beta1"], opt["beta2"]
    out = Readings()
    with no_tf32():
        for count, batch in enumerate(batches):
            tree = _unflatten(params, dict(zip(names, p)))
            loss = model.loss(tree, cfg, batch, precision=precision, rows=rows)
            grads = torch.autograd.grad(loss, p)
            out.losses.append(float(loss.detach()))
            del tree, loss
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = opt["grad_clip"] / gnorm if float(gnorm) > opt["grad_clip"] else 1.0
                lr = lr_at(opt, count)
                bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
                for x, g, m, v in zip(p, grads, mu, nu):
                    g = g * scale
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
                    x.sub_(lr * (upd + opt["weight_decay"] * x))
            del grads
            if count == 0:
                out.global_norm = float(gnorm)
                out.unclip = unclip_factor(out.global_norm, opt["grad_clip"])
                out.first_grads = {n: m / (1 - b1) for n, m in zip(names, mu)}
                out.grad_norms = {n: norm(g) for n, g in out.first_grads.items()}
    out.change_norms = {n: norm(x.detach() - x0) for n, x, x0 in zip(names, p, start)}
    return out


def _unflatten(like: Any, by_name: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, by_name, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, by_name, f"{prefix}{i}/") for i, v in enumerate(like)]
    return by_name[prefix[:-1]]
