"""Roofline terms of one NVIDIA H100 SXM5 80GB.

Counterpart of ``repro/launch/roofline.py``: ``collective_bytes``,
``RooflineTerms`` and ``model_flops`` are the reference's, unchanged;
the hardware constants are the card's, from NVIDIA's H100 Tensor Core
GPU datasheet (SXM5 column, dense rates without sparsity):

    compute term    = flops_per_device / PEAK_FLOPS
    memory term     = bytes_accessed_per_device / HBM_BW
    collective term = collective_bytes_per_device / LINK_BW

A device is one card. ``LINK_BW`` is one direction of its 18 NVLink 4
links (900 GB/s both ways); ``DCN_BW`` is one 400 Gb/s NDR InfiniBand
port a GPU, as in a DGX H100. ``collective_bytes`` sums the
*result-shape* bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute in a partitioned HLO text (per-partition
shapes). Result-shape is a deliberate, documented proxy: it equals
bytes-on-the-wire per device for ring all-gather and collective-permute,
and undercounts all-reduce by ~2x; the breakdown per op type is reported
so that can be seen. ``model_flops`` counts 6·N·D (training) or 2·N·D
(forward) over the tokens it is given.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

PEAK_FLOPS = 989.4e12    # bf16 dense, tensor cores (H100 SXM5 datasheet)
HBM_BW = 3.35e12         # B/s HBM3 (H100 SXM5 datasheet)
LINK_BW = 450e9          # B/s one direction of 18 NVLink 4 links (datasheet: 900 GB/s)
DCN_BW = 50e9            # B/s one 400 Gb/s NDR port a GPU (DGX H100)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(r"\s(" + "|".join(_COLL_KINDS) + r")(-start)?\(")


def _result_bytes(line: str) -> int:
    """Sum shape bytes on the lhs of `%name = <shapes> op(...)`."""
    head = line.split("(", 1)[0]
    if " = " in head:
        head = head.split(" = ", 1)[1]
    total = 0
    for dt, dims in _SHAPE_RE.findall(head):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-partition collective bytes by op kind (result-shape proxy).

    Async pairs: the ``-done`` op aliases the ``-start`` result, so only
    ``-start`` (and synchronous forms) are counted.
    """
    out: Dict[str, int] = {k: 0 for k in _COLL_KINDS}
    out["count"] = 0
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _OP_RE.search(line)
        if not m or " = " not in line:
            continue
        kind = m.group(1)
        nbytes = _result_bytes(line)
        if m.group(2):  # -start results carry (input, output, ...) tuples
            nbytes //= 2
        out[kind] += nbytes
        out["count"] += 1
    out["total"] = sum(out[k] for k in _COLL_KINDS)
    return out


@dataclass
class RooflineTerms:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    n_chips: int
    model_flops_global: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / compiled HLO flops (remat/redundancy waste)."""
        hlo_global = self.flops_per_dev * self.n_chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the machine at the modeled bound:
        (MODEL_FLOPS / peak) / max(term)."""
        if self.bound_s <= 0:
            return 0.0
        ideal_s = self.model_flops_global / (self.n_chips * PEAK_FLOPS)
        return ideal_s / self.bound_s

    def row(self) -> Dict[str, object]:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": {
                k: v for k, v in self.coll_breakdown.items() if v
            },
        }


def model_flops(kind: str, n_params_active: int, global_batch: int, seq_len: int) -> float:
    """6·N·D for training, 2·N·D forward-only; decode processes B tokens."""
    if kind == "train":
        return 6.0 * n_params_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_params_active * global_batch * seq_len
    if kind == "decode":
        return 2.0 * n_params_active * global_batch  # one new token per seq
    raise ValueError(kind)
