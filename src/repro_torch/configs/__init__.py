"""Architecture registry: exact public configs + reduced smoke twins.

A copy of ``repro/configs`` (the configs are data; the port imports no
``repro`` module), with imports pointed at ``repro_torch.models.config``.

Every module exposes ``config()`` (the exact published architecture) and
``smoke_config()`` (same family, tiny dims — one CPU forward/train step
in tests).  ``SHAPES`` defines the assigned input-shape cells; a cell is
*applicable* unless it is a decode cell for an encoder-only arch or the
``long_500k`` cell for a quadratic-attention arch (see
``cell_applicable``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCHS = (
    "xlstm-350m",
    "qwen2-72b",
    "llama3-405b",
    "qwen1.5-0.5b",
    "tinyllama-1.1b",
    "llava-next-mistral-7b",
    "qwen2-moe-a2.7b",
    "llama4-scout-17b-a16e",
    "recurrentgemma-2b",
    "whisper-small",
)


def _modname(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_modname(arch)).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_modname(arch)).smoke_config()


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
