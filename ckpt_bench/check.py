"""The numbers that decide ``correct``, and their limits.

The model step: the program's :class:`~ckpt_bench.reference.train.Readings`
of its first steps against the reference's from the same parameters and
batches. Each number is the worst over steps or leaves:

* ``loss_gap``: ``|loss - loss_ref| / |loss_ref|``, the worst step;
* ``grad_gap``: per leaf the gap between the program's and the
  reference's norm of the first gradient as the optimizer got it, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero);
* ``grad_diff``, ``grad_diff_median``: per leaf the norm of the
  difference between the program's and the reference's first gradient,
  over the same denominator; the worst leaf and the median leaf. Two
  gradients of the same norm but other directions, as float8 products
  give, differ here where ``grad_gap`` sees nothing;
* ``raw_grad_diff_median``: ``grad_diff`` of the median leaf on the
  gradients before the clip, each side's clipped gradient scaled back
  by the factor its own global norm set. The clip by the global norm
  scales every leaf alike, so where one leaf's gradient is
  ill-conditioned and the global norm lies near the clip, the clip
  acts on one side only and moves every leaf's clipped gradient;
* ``grad_dir_median``: per leaf the norm of the difference between the
  two first gradients each scaled to norm one, the median leaf (free
  of the clip, as of any scale);
* ``change_gap``: the gap of the norms of the parameters' change over
  the steps, each side's change taken from its own starting parameters
  (the program's as its parameter type holds them), over the leaves
  whose reference gradient is at least a thousandth of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam
  by round-off alone).

The checkpoint round trip counts bytes: every restored leaf against the
benchmark's own copy of the state it saved, byte for byte. Limits live
in ``ckpt_bench/limits/<cell>.json``.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict, Tuple

import torch

from ckpt_bench.reference.train import Readings, norm
from ckpt_bench.tree import flatten

MOVING_SHARE = 1e-3


def step_numbers(prog: Readings, ref: Readings) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """``({loss_gap, grad_gap, grad_diff, grad_diff_median,
    raw_grad_diff_median, grad_dir_median, change_gap}, details)``."""
    if (set(prog.grad_norms) != set(ref.grad_norms) or set(prog.first_grads) != set(ref.grad_norms)
            or len(prog.losses) != len(ref.losses)):
        raise ValueError("the program's leaves or steps differ from the reference's")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses))
    med_g = statistics.median(ref.grad_norms.values())
    grad = {n: abs(prog.grad_norms[n] - g) / max(g, med_g) for n, g in ref.grad_norms.items()}
    diff = {n: norm(prog.first_grads[n].to(g.device, torch.float32) - g)
            / max(ref.grad_norms[n], med_g) for n, g in ref.first_grads.items()}
    raw_norms = {n: g * ref.unclip for n, g in ref.grad_norms.items()}
    med_raw = statistics.median(raw_norms.values())
    raw = {n: norm(prog.first_grads[n].to(g.device, torch.float32) * prog.unclip - g * ref.unclip)
           / max(raw_norms[n], med_raw) for n, g in ref.first_grads.items()}
    dirs = {n: norm(_unit(prog.first_grads[n].to(g.device, torch.float32)) - _unit(g))
            for n, g in ref.first_grads.items()}
    moving = [n for n, g in ref.grad_norms.items() if g >= MOVING_SHARE * med_g]
    med_c = statistics.median(ref.change_norms[n] for n in moving)
    change = {n: abs(prog.change_norms[n] - ref.change_norms[n]) / max(ref.change_norms[n], med_c)
              for n in moving}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    worst_d = max(diff, key=diff.get)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad[worst_g], "grad_diff": diff[worst_d],
               "grad_diff_median": statistics.median(diff.values()),
               "raw_grad_diff_median": statistics.median(raw.values()),
               "grad_dir_median": statistics.median(dirs.values()),
               "change_gap": change[worst_c]}
    details = {"worst_grad_leaf": worst_g, "worst_diff_leaf": worst_d,
               "worst_change_leaf": worst_c, "grad_gaps": grad, "grad_diffs": diff,
               "change_gaps": change,
               "unmoved_leaves": sorted(set(ref.grad_norms) - set(moving)),
               "losses": prog.losses, "ref_losses": ref.losses}
    return numbers, details


def _unit(t: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(t)
    return t / n if float(n) > 0 else torch.zeros_like(t)


def mismatched_bytes(got: Any, want: Any) -> torch.Tensor:
    """Bytes in which the leaves of ``got`` differ from those of ``want``
    (same names, shapes and dtypes), as a 0-d int64 tensor on their
    device: nothing is read back to the host."""
    g, w = flatten(got), flatten(want)
    if [n for n, _ in g] != [n for n, _ in w]:
        raise ValueError("the restored tree's leaves differ from the saved tree's")
    total = torch.zeros((), dtype=torch.int64, device=w[0][1].device)
    for (name, a), (_, b) in zip(g, w):
        if a.dtype != b.dtype or a.shape != b.shape:
            total += b.numel() * b.element_size()
            continue
        total += (a.contiguous().view(-1).view(torch.uint8)
                  != b.contiguous().view(-1).view(torch.uint8)).sum()
    return total


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a missing or NaN number fails)."""
    return all(name in numbers and numbers[name] <= limit for name, limit in limits.items())
