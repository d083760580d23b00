"""Uniform model facade over the architecture families.

Counterpart of ``repro/models/api.py``. Only the families that route to
the decoder-only transformer (``dense``; ``moe`` and ``vlm`` raise in
the model until ROADMAP Queue 1 item 7) are ported; the recurrent,
hybrid and audio families raise. ``init`` returns the
:class:`~repro_torch.models.transformer.Transformer` module, whose
``state_tree()`` is the parameter tree that ``loss``, ``forward``,
``prefill`` and ``decode_step`` take, as the reference's ``init``
returns its tree. A cache is a
:class:`~repro_torch.models.transformer.DecodeCache`; ``cache_struct``
gives one on the meta device (shapes and dtypes, no memory) where the
reference gives ``ShapeDtypeStruct`` leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 7)"
        )
    raise ValueError(f"unknown family {cfg.family!r}")


def _extra_kwargs(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    if cfg.family == "vlm" and "patches" in batch:
        return {"patches": batch["patches"]}
    return {}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def mod(self):
        return _family_module(self.cfg)

    # -- parameters ---------------------------------------------------------
    def init(self, generator: torch.Generator, device: Any = "cuda") -> transformer.Transformer:
        """The model's module with parameters drawn from ``generator``
        on ``device`` (``"cuda"`` raises without a card)."""
        _family_module(self.cfg)  # raises for a family not ported yet
        return transformer.Transformer(
            self.cfg, device=resolve_device(device), generator=generator
        )

    def param_count(self) -> int:
        """Parameters of the model, counted on the meta device (no
        memory). ``active_only`` comes with the MoE family."""
        _family_module(self.cfg)
        module = transformer.Transformer(self.cfg, device="meta")
        return sum(math.prod(p.shape) for p in module.parameters())

    # -- training -----------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any], *, remat: bool = True):
        return self.mod.lm_loss(
            params, self.cfg, batch["tokens"], remat=remat,
            **_extra_kwargs(self.cfg, batch),
        )

    def forward(self, params, batch: Dict[str, Any], *, remat: bool = False):
        return self.mod.forward(
            params, self.cfg, batch["tokens"], remat=remat,
            **_extra_kwargs(self.cfg, batch),
        )

    # -- serving --------------------------------------------------------------
    def prefill(self, params, batch: Dict[str, Any], *, s_max: Optional[int] = None):
        return self.mod.prefill(
            params, self.cfg, batch["tokens"], s_max=s_max,
            **_extra_kwargs(self.cfg, batch),
        )

    def decode_step(self, params, cache, tokens):
        return self.mod.decode_step(params, self.cfg, cache, tokens)

    def cache_struct(self, b: int, s_max: int) -> transformer.DecodeCache:
        _family_module(self.cfg)
        return transformer.init_cache(self.cfg, b, s_max, device="meta")

    def init_cache(self, params, b: int, s_max: int) -> transformer.DecodeCache:
        """A zero cache on the device of ``params``' embedding."""
        _family_module(self.cfg)
        return transformer.init_cache(self.cfg, b, s_max, device=params["embed"].device)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
