"""A whole run with the timed path broken underneath comes out not
correct: once for each fault a cell can have (a step that returns its
state unchanged; half of the batch left out, the mean taken over the
rest; a restored answer altered where it is produced). One chip holds
every cell, so no exchange between chips can be left out. The look for
a chip is skipped: the runs are on the CPU at smoke sizes, held to the
cells' own limits."""
import pytest
import torch
from conftest import run_smoke

from ckpt_bench.tree import flatten

CELLS = ["whisper-small.save", "xlstm-350m.resume", "whisper-small.train"]


def unchanged_state(monkeypatch):
    import repro_torch.train.train_step as ts

    def no_update(grads, opt_state, params, cfg, grad_norm=None):
        zero = torch.zeros((), dtype=torch.float32)
        return {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(ts, "adamw_update", no_update)


def half_batch(monkeypatch):
    from repro_torch.models.api import Model

    loss = Model.loss

    def half(self, params, batch, *, remat=True):
        return loss(self, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()},
                    remat=remat)

    monkeypatch.setattr(Model, "loss", half)


def altered_answer(monkeypatch):
    from repro_torch.core.engine import CheckpointManager

    restore = CheckpointManager.restore

    def altered(self, target, step=None, **kw):
        got, tree = restore(self, target, step, **kw)
        leaf = flatten(tree["train"]["params"])[0][1]
        leaf.view(-1).view(torch.uint8)[0] ^= 1
        return got, tree

    monkeypatch.setattr(CheckpointManager, "restore", altered)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "altered_answer" or c != "whisper-small.train"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run_smoke(cell, seconds=0.5)
    assert res["correct"] is False
    failed = [n for n, c in res["checks"].items() if not c["value"] <= c["limit"]]
    steps = {"grad_gap", "grad_diff", "grad_diff_median", "raw_grad_diff_median",
             "grad_dir_median", "change_gap"}
    caught_by = {"unchanged_state": steps, "half_batch": steps | {"loss_gap"},
                 "altered_answer": {"restore_bad_bytes"}}[fault]
    assert caught_by & set(failed), res["checks"]
