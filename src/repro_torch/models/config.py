"""Model configuration dataclasses for every supported architecture family.

Counterpart of ``repro/models/config.py``; ``pdt`` and ``cdt`` give
``torch.dtype``s. The port's own fields, all off by default so that every
configuration the reference has reads as it does there: the experts one
device holds of a wider router, DeepSeek's routing (softmax over all
experts, the selected probabilities as weights, a sequence-wise aux loss,
no capacity), latent attention (MLA) with YaRN rope, and leading dense
layers before the MoE layers. ``moe`` and ``rope_scaling`` may be given
as plain dicts (a configuration read from JSON) and are built here.
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
    # experts held here: ``n_held`` of the router's ``n_experts`` from
    # ``held_start`` (0: all of them); a layer computes only their part
    n_held: int = 0
    held_start: int = 0
    # DeepSeek-V2-Lite's routing (``dropless``): softmax over every
    # expert, the top-k probabilities as weights, every slot kept, and
    # the aux loss per sequence, averaged over the batch
    dropless: bool = False

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts

    def __post_init__(self):
        if not 0 <= self.held_start <= self.held_start + self.held <= self.n_experts:
            raise ValueError(f"experts {self.held_start}..{self.held_start + self.held - 1} "
                             f"are not among the router's {self.n_experts}")
        if self.held != self.n_experts and not self.dropless:
            raise ValueError("a share of the experts needs dropless routing")


@dataclass(frozen=True)
class RopeScaling:
    """YaRN (arXiv:2309.00071) as DeepSeek-V2's config gives it, the only
    rope scaling. Cos and sin are not scaled: the config's ``mscale``
    equals ``mscale_all_dim``, so their ratio, YaRN's factor on them, is
    one; a given dict's ``type`` and ``mscale`` are not read."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0


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
    # latent attention (MLA; on where kv_lora_rank > 0), names as
    # DeepSeek-V2's config has them; queries are not compressed
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_scaling: Optional[RopeScaling] = None
    # leading layers with a dense FFN of width d_ff before the MoE layers
    first_k_dense_replace: int = 0

    def __post_init__(self):
        if isinstance(self.moe, dict):
            object.__setattr__(self, "moe", MoEConfig(**self.moe))
        if isinstance(self.rope_scaling, dict):
            names = {f.name for f in dataclasses.fields(RopeScaling)}
            object.__setattr__(self, "rope_scaling", RopeScaling(
                **{k: v for k, v in self.rope_scaling.items() if k in names}))
        if self.first_k_dense_replace and self.moe is None:
            raise ValueError("leading dense layers come before MoE layers")
        if not 0 <= self.first_k_dense_replace <= self.n_layers:
            raise ValueError(f"first_k_dense_replace {self.first_k_dense_replace} "
                             f"of {self.n_layers} layers")

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def n_moe_layers(self) -> int:
        return 0 if self.moe is None else self.n_layers - self.first_k_dense_replace

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
