"""Minimal batched serving engine: prefill once, decode greedily.

Counterpart of ``repro/serve/engine.py``. Serving snapshots (params +
live KV caches) checkpoint through the same CheckpointManager as
training state; a snapshot restores into a fresh server that continues
with exactly the tokens the first one would have emitted.

Hot-swap safety: the server's weights live in one ``(params, version)``
tuple replaced atomically by :meth:`Server.swap_params`.  Each
:meth:`Server.generate` captures the tuple exactly once at entry, so a
swap landing mid-decode never tears a request across versions: the
in-flight generate finishes on the version it started with, the next
one picks up the new weights.  That single invariant is what lets
:class:`repro_torch.serve.fleet.ServeFleet`'s follower roll a live
fleet onto each new training step without draining requests.

The decode step runs eagerly (the reference jits it); ``generate`` runs
under ``torch.inference_mode()``, so parameters that are a trainer's
``nn.Parameter``\\ s build no autograd graph, and keeps the emitted
tokens on the device until the last step.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.utils.treelib import tree_leaves


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    s_max: Optional[int] = None  # cache capacity (default: prompt + new)


def params_device(params: Any) -> torch.device:
    """The one device every leaf of ``params`` lives on; raises when the
    leaves are spread over several."""
    devices = {t.device for t in tree_leaves(params)}
    if len(devices) != 1:
        raise ValueError(f"params must live on one device, not {sorted(map(str, devices))}")
    return devices.pop()


class Server:
    def __init__(self, model: Model, params: Any, cfg: ServeConfig = ServeConfig()):
        self.model = model
        # (params, version): replaced as ONE reference by swap_params so
        # readers can never observe half a swap
        self._current: Tuple[Any, int] = (params, 0)
        self._swap_lock = threading.Lock()
        self.cfg = cfg

    @property
    def params(self) -> Any:
        return self._current[0]

    @property
    def params_version(self) -> int:
        return self._current[1]

    def swap_params(self, params: Any) -> int:
        """Atomically roll the server onto new weights.

        In-flight :meth:`generate` calls keep the reference they
        captured at entry and finish undisturbed; calls entering after
        the swap see only the new version.  ``params`` must be resident,
        or their copies enqueued on the stream the generates run on; a
        caller uploading on a side stream waits for its event first.
        Returns the new version number (monotonic from 0)."""
        with self._swap_lock:  # serialize swappers; readers never block
            version = self._current[1] + 1
            self._current = (params, version)
        return version

    @classmethod
    def from_checkpoint(
        cls,
        model: Model,
        manager: Any,
        params_template: Any,
        *,
        step: Optional[int] = None,
        prefix: str = "['params']",
        cfg: ServeConfig = ServeConfig(),
        sharding_fn: Optional[Any] = None,
        retry: Optional[Any] = None,
    ) -> Tuple["Server", int]:
        """Boot a server straight from a checkpoint's params subtree.

        Uses the manager's partial-restore path
        (:meth:`~repro_torch.core.engine.CheckpointManager.restore_subtree`),
        so only the params' byte ranges are read from the aggregated
        files, onto the manager's device (or through ``sharding_fn``).
        ``params_template`` gives only the structure; it may live on the
        meta device.  ``prefix`` is the leaf-name prefix the params were
        saved under (``"['params']"`` for :meth:`snapshot_state`
        snapshots, ``"['train']['params']"`` for the trainer's).

        ``retry`` (a :class:`~repro_torch.core.storage.RetryPolicy`)
        retries the whole restore.  Only I/O failures (``OSError``,
        which covers :class:`StorageError` and the ``FileNotFoundError``
        the restore ladder raises when every candidate fails) are
        transient; a programming error (``TypeError``, ``KeyError``, a
        bad template) raises immediately instead of burning the retry
        deadline.
        """
        def restore():
            return manager.restore_subtree(
                params_template, prefix, step=step, sharding_fn=sharding_fn
            )

        if retry is not None:
            policy = dataclasses.replace(
                retry,
                classify=lambda e: (
                    "transient" if isinstance(e, OSError) else "permanent"
                ),
            )
            step_out, params = policy.run(restore)
        else:
            step_out, params = restore()
        return cls(model, params, cfg), step_out

    def generate(
        self, batch: Dict[str, Any], *, with_version: bool = False
    ) -> Union[Tuple[np.ndarray, Any], Tuple[np.ndarray, Any, int]]:
        """Greedy decode; returns (generated tokens (B, T_new) int32 on
        the host, final cache on the params' device).

        Every entry of ``batch`` (``tokens``, and a VLM's ``patches`` or
        an audio model's ``frames``; NumPy arrays or tensors) goes to the
        params' device.  With ``with_version=True`` also returns the params
        version this generate ran against.  The params reference is
        captured ONCE here: a concurrent :meth:`swap_params` cannot
        change the weights mid-request."""
        params, version = self._current  # the one atomic capture
        dev = params_device(params)
        with torch.inference_mode():
            inputs = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            s = inputs["tokens"].shape[1]
            s_max = self.cfg.s_max or (s + self.cfg.max_new_tokens)
            cache, logits = self.model.prefill(params, inputs, s_max=s_max)
            elsewhere = {str(t.device) for t in tree_leaves(cache)
                         if isinstance(t, torch.Tensor) and t.device != dev}
            if elsewhere:
                raise RuntimeError(f"cache on {sorted(elsewhere)}, params on {dev}")
            outs = []
            tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
            for _ in range(self.cfg.max_new_tokens):
                outs.append(tok[:, 0])
                logits, cache = self.model.decode_step(params, cache, tok)
                tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
            toks = torch.stack(outs, dim=1).cpu().numpy()
        if with_version:
            return toks, cache, version
        return toks, cache

    def snapshot_state(self, cache: Any) -> Dict[str, Any]:
        """Checkpointable serving snapshot (params + cache)."""
        return {"params": self.params, "cache": cache}
