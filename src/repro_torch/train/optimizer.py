"""AdamW + schedules, from scratch (not ``torch.optim.AdamW``).

Counterpart of ``repro/train/optimizer.py``: the same update in float32
(global-norm clipping, bias corrections ``1 - beta**count`` in float32,
then ``p - lr * (step + wd * p)``), where ``torch.optim.AdamW`` decays
and rounds differently. The update is done in place under
``torch.no_grad()``, so a module's parameters and the train state stay
one set of storages; an in-place update issued after
``CheckpointManager.stage()`` on the same stream is ordered behind the
staged copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.models.config import TORCH_DTYPES
from repro_torch.utils.treelib import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Optional[str] = None   # None -> match param dtype
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"            # cosine | constant
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at optimizer step ``step`` (a tensor), in
    float32 on the step's device."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    def z(p):
        dt = TORCH_DTYPES[cfg.state_dtype] if cfg.state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    leaf = tree_leaves(params)[0]
    return {
        "mu": tree_map(z, params),
        "nu": tree_map(z, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


@torch.no_grad()
def adamw_update(
    grads: Any, opt_state: Dict[str, Any], params: Any, cfg: OptConfig
) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``opt_state``.
    Returns ``{"grad_norm", "lr"}`` (0-d float32 tensors)."""
    count = opt_state["count"] + 1
    cf = count.float()
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.grad_clip)
    # tensor / tensor: a true division on every device
    scale = torch.where(
        gnorm > cfg.grad_clip, clip / torch.clamp(gnorm, min=1e-9), torch.ones_like(gnorm)
    )
    lr = lr_at(cfg, opt_state["count"])
    bc1 = 1.0 - cfg.beta1 ** cf
    bc2 = 1.0 - cfg.beta2 ** cf

    for p, g, mu, nu in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]),
    ):
        gf = g.float() * scale
        mu_f = cfg.beta1 * mu.float() + (1 - cfg.beta1) * gf
        nu_f = cfg.beta2 * nu.float() + (1 - cfg.beta2) * gf * gf
        step = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (step + cfg.weight_decay * pf)
        p.copy_(pf)
        mu.copy_(mu_f)
        nu.copy_(nu_f)
    opt_state["count"].copy_(count)
    return {"grad_norm": gnorm, "lr": lr}
