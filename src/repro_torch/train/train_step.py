"""Train-step builder: gradient accumulation, remat, in-place AdamW.

Counterpart of ``repro/train/train_step.py``. The train state is the
reference's tree ``{"params", "opt": {"mu", "nu", "count"}, "step"}``
with ``count`` and ``step`` 0-d int32 tensors; its ``params`` leaves
are the model module's own parameters (``Model.init``: a transformer's
stacks, or the recurrent families' per-layer ``blocks``). The step updates the state in place and returns it.

Microbatches run as a Python loop (``lax.scan`` there), every batch
leaf (the tokens, and a VLM batch's patches) split on its first axis
and each gradient added as ``g_acc + g / k`` in ``accum_dtype``. The
loss is the model's: cross-entropy plus the MoE layers' aux loss. A
dropless MoE model's routing counts go to the recorder on the device
(``telemetry.count_device``, :data:`MOE_COUNTERS`), read back only when
it is drained.

``make_train_step`` is the step on a ``DeviceMesh``: the state's leaves
are DTensors laid out by ``train_state_specs`` (the reference's
partition rules), FSDP over ``fsdp_axes(mesh)`` plus data parallelism.
Each rank gathers the whole parameters just in time, runs the loss and
gradients of ``build_train_step`` on its shard of the batch (cut by
``batch_spec_tree``), averages the gradients and the loss over the
data-parallel ranks (an all-reduce, skipped at one), clips by the norm
of the whole averaged gradients and updates its own shards in place.
The model runs on plain tensors, never on DTensor activations, so on a
mesh of one device the step is ``build_train_step``'s bit for bit. Over
"model" the state is stored sharded but the compute is replicated
(GSPMD would partition it too).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.models.api import Model
from repro_torch.models.config import TORCH_DTYPES
from repro_torch.models.sharding import (
    P, _maybe, axis_size, fsdp_axes, is_spec, local_shard, mesh_shape, param_specs,
    to_placements,
)
from repro_torch.train.optimizer import OptConfig, adamw_update, global_norm, init_opt_state
from repro_torch.utils import telemetry
from repro_torch.utils.convert import whole_tensor
from repro_torch.utils.treelib import flatten_with_names, tree_leaves, tree_map, unflatten


# a dropless MoE model's routing counts, summed over its layers (the
# forward's; remat's recompute is not counted again): every (token, k)
# slot, the slots of the experts held here, the busiest held expert's
MOE_COUNTERS = ("moe.routed_slots", "moe.held_slots", "moe.held_max_slots")


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


def train_state_specs(model: Model, mesh: Any, tcfg: TrainConfig) -> Dict[str, Any]:
    pspecs = param_specs(model, mesh)
    return {
        "params": pspecs,
        "opt": {
            "mu": pspecs,
            "nu": pspecs,
            "count": P(),
        },
        "step": P(),
    }


def batch_spec_tree(model: Model, mesh: Any, batch_struct: Any) -> Any:
    F = fsdp_axes(mesh)

    def spec(leaf):
        rank = len(leaf.shape)
        return P(_maybe(leaf.shape[0], F, mesh), *([None] * (rank - 1)))

    return tree_map(spec, batch_struct)


def _loss_and_grads(model: Model, tcfg: TrainConfig):
    """``(params, batch) -> (loss, grads)``: the loss (detached) and the
    gradients of ``params``, accumulated over ``tcfg.microbatches``."""

    def grads_of(params, mb):
        named, treedef = flatten_with_names(params)
        loss, extras = model.loss(params, mb, remat=tcfg.remat)
        if "moe_counts" in extras:
            telemetry.count_device(MOE_COUNTERS, extras["moe_counts"])
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.detach(), unflatten(treedef, list(grads))

    def loss_and_grads(params, batch):
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
        return loss, grads

    return loss_and_grads


def build_train_step(model: Model, tcfg: TrainConfig):
    """The step: ``(state, batch) -> (state, metrics)``, with the state
    updated in place and metrics ``{"loss", "grad_norm", "lr"}`` as 0-d
    float32 tensors (not synchronised)."""
    loss_and_grads = _loss_and_grads(model, tcfg)

    def train_step(state, batch):
        params = state["params"]
        with telemetry.span("train.loss_and_grads"):
            loss, grads = loss_and_grads(params, batch)
        with telemetry.span("train.update"):
            om = adamw_update(grads, state["opt"], params, tcfg.opt)
            with torch.no_grad():
                state["step"].add_(1)
        return state, {"loss": loss.float(), **om}

    return train_step


def make_train_step(model: Model, tcfg: TrainConfig, mesh: Any, batch_struct: Any):
    """The step on ``mesh`` (a ``DeviceMesh``); returns ``(fn,
    state_specs, batch_specs)``. ``fn(state, batch) -> (state, metrics)``
    takes the state placed by ``state_specs``
    (:func:`~repro_torch.models.sharding.place`) and the whole batch of
    plain tensors (every rank's copy) or DTensors, and updates the state
    in place."""
    sspecs = train_state_specs(model, mesh, tcfg)
    bspecs = batch_spec_tree(model, mesh, batch_struct)
    param_pl = [to_placements(s, mesh)
                for s in tree_leaves(sspecs["params"], is_leaf=is_spec)]
    batch_pl = [to_placements(s, mesh) for s in tree_leaves(bspecs, is_leaf=is_spec)]
    dp = axis_size(mesh, fsdp_axes(mesh))
    # the data-parallel ranks of this rank: one group a data axis
    dp_groups = [mesh.get_group(a) for a in fsdp_axes(mesh) if mesh_shape(mesh)[a] > 1]
    loss_and_grads = _loss_and_grads(model, tcfg)

    def dp_mean_(t: torch.Tensor) -> None:
        for group in dp_groups:
            dist.all_reduce(t, group=group)
        t.div_(dp)

    def local_batch(x, pl):
        from torch.distributed.tensor import DTensor

        return x.to_local() if isinstance(x, DTensor) else local_shard(x, mesh, pl)

    def train_step(state, batch):
        named, treedef = flatten_with_names(state["params"])
        params = unflatten(treedef, [whole_tensor(x).detach().requires_grad_()
                                     for _, x in named])
        b_named, b_def = flatten_with_names(batch)
        mine = unflatten(b_def, [local_batch(x, pl) for (_, x), pl in zip(b_named, batch_pl)])
        loss, grads = loss_and_grads(params, mine)
        del params
        g_leaves = tree_leaves(grads)
        with torch.no_grad():
            if dp > 1:
                for g in g_leaves:
                    dp_mean_(g)
                dp_mean_(loss)
            gnorm = global_norm(g_leaves)
            local = tree_map(lambda d: d.to_local(), state)
            shards = [local_shard(g, mesh, pl) for g, pl in zip(g_leaves, param_pl)]
            om = adamw_update(unflatten(treedef, shards), local["opt"], local["params"],
                              tcfg.opt, grad_norm=gnorm)
            local["step"].add_(1)
        return state, {"loss": loss.float(), **om}

    return train_step, sspecs, bspecs
