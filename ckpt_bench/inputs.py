"""Every input of a run, made from ``--seed`` on the run's device.

The initial parameters come from the reference's ``param_specs`` (names,
shapes and how each is drawn): all normal draws in one call of one
generator, then sliced and scaled leaf by leaf. Batch ``j`` of a traffic
mix is a function of ``(seed, j)``: ``global_batch`` rows of
``seq_len`` token ids drawn uniformly from the vocabulary, and for an
encoder-decoder as many rows of ``enc_seq`` standard normal frame
embeddings (float32). The same seed gives the same inputs to the
program and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ckpt_bench.tree import flatten, tree_map

_MASK = (1 << 63) - 1


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed mixed from ``seed`` and ``keys`` (splitmix64)."""
    x = int(seed) & ((1 << 64) - 1)
    for k in keys:
        x = (x + 0x9E3779B97F4A7C15 * (int(k) + 1)) & ((1 << 64) - 1)
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x ^= x >> 31
    return x & _MASK


def make_params(specs: Any, seed: int, device: Any) -> Any:
    """The parameter tree of ``specs`` (leaves ``(shape, kind, arg)``),
    float32 on ``device``."""
    normal = [s for _, s in flatten(specs) if s[1] == "normal"]
    total = sum(math.prod(s[0]) for s in normal)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 1))
    draws = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    offset = [0]

    def make(spec):
        shape, kind, arg = spec
        if kind == "normal":
            n = math.prod(shape)
            t = draws[offset[0]: offset[0] + n].view(shape) * arg
            offset[0] += n
            return t
        if kind == "const":
            return torch.full(shape, float(arg), dtype=torch.float32, device=device)
        if kind == "table":
            return torch.as_tensor(arg, dtype=torch.float32).reshape(shape).to(device)
        raise ValueError(f"unknown init {kind!r}")

    return tree_map(make, specs)


def make_batch(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, j: int,
               device: Any) -> Dict[str, torch.Tensor]:
    """Batch ``j`` of ``traffic`` for the configuration ``cfg``."""
    b, s = traffic["global_batch"], traffic["seq_len"]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 2, j))
    batch = {"tokens": torch.randint(0, cfg["vocab_size"], (b, s), generator=gen,
                                     device=device, dtype=torch.int64).to(torch.int32)}
    if cfg.get("encdec"):
        batch["frames"] = torch.randn((b, cfg["enc_seq"], cfg["d_model"]), generator=gen,
                                      dtype=torch.float32, device=device)
    return batch
