"""Model configuration dataclasses for every supported architecture family.

Counterpart of ``repro/models/config.py``; ``pdt`` and ``cdt`` give
``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts
    expert_d_ff: int = 0         # per-expert hidden dim
    shared_d_ff: int = 0         # shared-expert hidden dim (0 = expert_d_ff * n_shared)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # hybrid / ssm layer pattern, repeated to n_layers:
    #   dense/moe: ("attn",) -- implicit
    #   xlstm:     e.g. ("mlstm", "mlstm", "mlstm", "slstm")
    #   griffin:   ("rglru", "rglru", "attn")
    block_pattern: Tuple[str, ...] = ()
    window: Optional[int] = None          # local attention window (None = full)
    conv_width: int = 4                   # temporal conv width (ssm/hybrid)
    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                   # whisper-small 30s @ 50 Hz
    # vlm
    n_patches: int = 0                    # patch embeddings prepended (stub frontend)
    # attention q-chunking (memory-efficient attention granularity);
    # smaller for archs whose head count does not shard over TP
    chunk_q: int = 1024
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Sub-quadratic in sequence length?  Gates the long_500k shape cell.
    @property
    def subquadratic(self) -> bool:
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # recurrence + windowed attention
        return False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def pdt(self) -> torch.dtype:
        return TORCH_DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return TORCH_DTYPES[self.compute_dtype]

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        return ("attn",)

    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
