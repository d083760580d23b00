"""Deterministic, checkpointable synthetic token pipeline.

Counterpart of ``repro/data/pipeline.py``, with the same structure:
per row, a run ``base + step * pos`` (mod V) with a noise token at every
``pos % 17 == 0``, so the LM loss has structure to learn. Batch ``i`` is
a pure function of ``(seed, i)``: its draws come from a NumPy generator
keyed by ``[seed, i]``, so a restart from a checkpointed ``state``
replays the exact upcoming batches. (``jax.random`` draws cannot be
reproduced in torch, so the batches differ from the reference's; the
contract is the same.)

The VLM family's batch also holds ``patches``, float32 stub patch
embeddings (global_batch, n_patches, d_model), and the audio family's
``frames``, float32 stub frame embeddings (global_batch, enc_seq,
d_model), each drawn standard normal from the same generator after the
tokens, so a resume replays them too.

The state ``{"batch_idx": 0-d int32}`` rides inside the train
checkpoint. It is a host tensor: the host decides which batch to draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # vlm / audio frontends (stub embeddings)
    n_patches: int = 0
    enc_seq: int = 0
    d_model: int = 0
    family: str = "dense"


def _cursor(idx: Any) -> torch.Tensor:
    return torch.tensor(int(idx), dtype=torch.int32)


class SyntheticTokens:
    def __init__(
        self, cfg: DataConfig, state: Optional[Dict[str, Any]] = None, *, device: Any = "cuda"
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state: Dict[str, Any] = {"batch_idx": _cursor(0)}
        if state is not None:
            self.load_state(state)

    # -- deterministic batch as a function of (seed, idx) -------------------
    def batch_numpy(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, idx])
        v = cfg.vocab_size
        base = rng.integers(0, v, (cfg.global_batch, 1))
        step = rng.integers(1, 7, (cfg.global_batch, 1))
        pos = np.arange(cfg.seq_len)[None, :]
        runs = (base + step * pos) % v
        noise = rng.integers(0, v, runs.shape)
        keep = (pos % 17) != 0
        batch = {"tokens": np.where(keep, runs, noise).astype(np.int32)}
        if cfg.family == "vlm" and cfg.n_patches:
            batch["patches"] = rng.standard_normal(
                (cfg.global_batch, cfg.n_patches, cfg.d_model), dtype=np.float32)
        if cfg.family == "audio" and cfg.enc_seq:
            batch["frames"] = rng.standard_normal(
                (cfg.global_batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        return batch

    def _batch_at(self, idx: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.batch_numpy(idx).items()}

    def next(self) -> Dict[str, torch.Tensor]:
        idx = int(self.state["batch_idx"])
        batch = self._batch_at(idx)
        self.state = {"batch_idx": _cursor(idx + 1)}
        return batch

    def peek(self, idx: int) -> Dict[str, torch.Tensor]:
        return self._batch_at(idx)

    # state rides inside the training checkpoint
    def state_tree(self) -> Dict[str, Any]:
        return dict(self.state)

    def load_state(self, state: Dict[str, Any]) -> None:
        self.state = {"batch_idx": _cursor(state["batch_idx"])}
