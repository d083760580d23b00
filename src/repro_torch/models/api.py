"""Uniform model facade over the architecture families.

Counterpart of ``repro/models/api.py``: the decoder-only transformer
(``dense``, ``moe``, ``vlm``), xLSTM (``ssm``), Griffin (``hybrid``) and
the Whisper encoder-decoder (``audio``). Batch dict keys: ``tokens``
(always), ``patches`` (vlm), ``frames`` (audio). ``init`` returns the
family's module (:class:`~repro_torch.models.transformer.Transformer`,
:class:`~repro_torch.models.xlstm.XLSTM`,
:class:`~repro_torch.models.griffin.Griffin` or
:class:`~repro_torch.models.whisper.Whisper`), whose ``state_tree()`` is
the parameter tree that ``loss``, ``forward``, ``prefill`` and
``decode_step`` take, as the reference's ``init`` returns its tree.
``param_struct`` gives that tree on the meta device (shapes and dtypes,
no memory) where the reference gives ``ShapeDtypeStruct`` leaves, and so
do ``cache_struct`` and ``batch_struct``. A cache is a
:class:`~repro_torch.models.transformer.DecodeCache` for the
transformer families, a :class:`~repro_torch.models.whisper.WhisperCache`
(self K/V, the cross K/V of the encoder's memory, ``pos``) for whisper,
and the recurrent state dict of ``init_state`` for the others.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.models import griffin, transformer, whisper, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.utils.treelib import tree_leaves

# each ported family's module and the nn.Module class of its parameters
_FAMILIES = {
    "dense": (transformer, transformer.Transformer),
    "moe": (transformer, transformer.Transformer),
    "vlm": (transformer, transformer.Transformer),
    "ssm": (xlstm, xlstm.XLSTM),
    "hybrid": (griffin, griffin.Griffin),
    "audio": (whisper, whisper.Whisper),
}


def _family(cfg: ModelConfig):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    raise ValueError(f"unknown family {cfg.family!r}")


def _family_module(cfg: ModelConfig):
    return _family(cfg)[0]


def _extra_kwargs(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    kw = {}
    if cfg.family == "vlm" and "patches" in batch:
        kw["patches"] = batch["patches"]
    if cfg.family == "audio":
        kw["frames"] = batch["frames"]
    return kw


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def mod(self):
        return _family_module(self.cfg)

    # -- parameters ---------------------------------------------------------
    def build(self, device: Any, generator: Optional[torch.Generator] = None) -> nn.Module:
        """The family's parameter module on ``device``: drawn from
        ``generator``, or uninitialised without one (to be loaded)."""
        return _family(self.cfg)[1](self.cfg, device=device, generator=generator)

    def init(self, generator: torch.Generator, device: Any = "cuda") -> nn.Module:
        """The model's module with parameters drawn from ``generator``
        on ``device`` (``"cuda"`` raises without a card)."""
        return self.build(resolve_device(device), generator)

    def param_struct(self) -> Dict[str, Any]:
        """The parameter tree on the meta device: names, shapes and
        dtypes, no memory (a restore target)."""
        return self.build("meta").state_tree()

    def param_count(self, *, active_only: bool = False) -> int:
        """Parameters of the model, counted on the meta device (no
        memory). ``active_only``: less the routed experts a token does
        not use in each MoE layer (leading dense layers have none): of
        the experts held here, all but the ``top_k * held / n_experts``
        that a token uses on average (``n_experts - top_k`` where every
        expert is held), rounded to a whole parameter."""
        total = sum(math.prod(p.shape) for p in tree_leaves(self.param_struct()))
        if active_only and self.cfg.moe is not None:
            m = self.cfg.moe
            e_ff = m.expert_d_ff or self.cfg.d_ff
            unused = m.held - m.top_k * m.held / m.n_experts
            total -= round(3 * self.cfg.d_model * e_ff * unused * self.cfg.n_moe_layers)
        return total

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

    def cache_struct(self, b: int, s_max: int) -> Any:
        """The cache on the meta device (shapes and dtypes, no memory)."""
        mod = _family_module(self.cfg)
        if mod is transformer:
            return transformer.init_cache(self.cfg, b, s_max, device="meta")
        if mod is whisper:
            return whisper.cache_zeros(self.cfg, b, s_max, device="meta")
        return mod.init_state(None, self.cfg, b, device="meta")

    def init_cache(self, params, b: int, s_max: int, memory=None) -> Any:
        """A zero cache on the device of ``params``' embedding; whisper's
        holds the cross K/V of the encoder's ``memory``."""
        mod = _family_module(self.cfg)
        if mod is transformer:
            return transformer.init_cache(self.cfg, b, s_max, device=params["embed"].device)
        if mod is whisper:
            return whisper.init_cache(params, self.cfg, memory, b, s_max)
        return mod.init_state(params, self.cfg, b)

    # -- inputs ---------------------------------------------------------------
    def batch_struct(self, batch_size: int, seq_len: int) -> Dict[str, torch.Tensor]:
        """A batch's tensors on the meta device: a VLM batch's row is
        ``n_patches`` patch embeddings (compute dtype) and the text
        that fills ``seq_len`` (at least one token); an audio batch's is
        ``enc_seq`` frame embeddings (compute dtype) and ``seq_len``
        tokens."""
        cfg = self.cfg
        _family_module(cfg)
        if cfg.family == "vlm":
            n_text = max(1, seq_len - cfg.n_patches)
            return {
                "tokens": torch.empty((batch_size, n_text), dtype=torch.int32, device="meta"),
                "patches": torch.empty((batch_size, cfg.n_patches, cfg.d_model),
                                       dtype=cfg.cdt, device="meta"),
            }
        if cfg.family == "audio":
            return {
                "tokens": torch.empty((batch_size, seq_len), dtype=torch.int32, device="meta"),
                "frames": torch.empty((batch_size, cfg.enc_seq, cfg.d_model),
                                      dtype=cfg.cdt, device="meta"),
            }
        return {"tokens": torch.empty((batch_size, seq_len), dtype=torch.int32, device="meta")}


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
