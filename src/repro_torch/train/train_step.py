"""Train-step builder: gradient accumulation, remat, in-place AdamW.

Counterpart of ``repro/train/train_step.py``. The train state is the
reference's tree ``{"params", "opt": {"mu", "nu", "count"}, "step"}``
with ``count`` and ``step`` 0-d int32 tensors; its ``params`` leaves
are the model module's own parameters (``Model.init``: a transformer's
stacks, or the recurrent families' per-layer ``blocks``). The step updates the state in place and returns it.

Microbatches run as a Python loop (``lax.scan`` there), every batch
leaf (the tokens, and a VLM batch's patches) split on its first axis
and each gradient added as ``g_acc + g / k`` in ``accum_dtype``. The
loss is the model's: cross-entropy plus the MoE layers' aux loss. ``train_state_specs``,
``batch_spec_tree`` and ``make_train_step`` (mesh shardings) come with
the DeviceMesh slice (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import TORCH_DTYPES
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, unflatten


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    microbatches: int = 1
    remat: bool = True
    accum_dtype: str = "float32"   # grad-accumulator dtype


def init_train_state(
    model: Model, generator: torch.Generator, tcfg: TrainConfig, device: Any = "cuda"
) -> Dict[str, Any]:
    params = model.init(generator, device).state_tree()
    return {
        "params": params,
        "opt": init_opt_state(params, tcfg.opt),
        "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def build_train_step(model: Model, tcfg: TrainConfig):
    """The step: ``(state, batch) -> (state, metrics)``, with the state
    updated in place and metrics ``{"loss", "grad_norm", "lr"}`` as 0-d
    float32 tensors (not synchronised)."""

    def grads_of(params, mb):
        named, treedef = flatten_with_names(params)
        loss, _ = model.loss(params, mb, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.detach(), unflatten(treedef, list(grads))

    def train_step(state, batch):
        params = state["params"]
        k = tcfg.microbatches
        if k > 1:
            adt = TORCH_DTYPES[tcfg.accum_dtype]
            leaves = tree_leaves(params)
            g_acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for j in range(k):
                mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[j]
                      for key, x in batch.items()}
                l, g = grads_of(params, mb)
                g_acc = [a + b.to(a.dtype) / k for a, b in zip(g_acc, tree_leaves(g))]
                loss = loss + l / k
            grads = unflatten(flatten_with_names(params)[1], g_acc)
        else:
            loss, grads = grads_of(params, batch)
        om = adamw_update(grads, state["opt"], params, tcfg.opt)
        with torch.no_grad():
            state["step"].add_(1)
        return state, {"loss": loss.float(), **om}

    return train_step
