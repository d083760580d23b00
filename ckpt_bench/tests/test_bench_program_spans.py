"""The program's own spans in the benchmark: ``program_spans.nest`` on
made-up spans, and the three readers of program spans and ``phases.py``'s
idle by phase on the save and resume cells at smoke sizes, traced and
not."""
import sys
from collections import namedtuple

import pytest
from conftest import SEED, smoke_cell

from ckpt_bench import bench, phases, program_spans, trace

S = namedtuple("S", "name start_ns end_ns thread id parent step")
READERS = {"whisper-small.save": ("flush_step_slowdown",),
           "xlstm-350m.resume": ("restore_decode_s", "restore_place_s")}


def run_smoke(name, keep, traced=False):
    """Cell ``name`` at smoke sizes. The save cell saves at a quarter and
    half of a 12 s window (a loaded host can take seconds over the
    window's first step), its flushes capped at 4 MB/s: steps clear of
    any ``stage()`` run beside each flush."""
    cell = smoke_cell(name)
    seconds = 1.0
    if name == "whisper-small.save":
        cell.cfg["checkpoint"] = dict(cell.cfg["checkpoint"], flush_bw_cap=4e6)
        cell.traffic = dict(cell.traffic, save_at=[0.25, 0.5])
        seconds = 12.0
    return bench.run_cell(cell, SEED, seconds, traced=traced, device="cpu",
                          log=lambda *a, **k: None, keep=keep)


def made_up():
    """Benchmark spans (on the trace's clock: offset 1,000) and the
    program's (loop thread 1; a flush on thread 2)."""
    spans = trace.Spans()
    spans._offset = 1_000
    for label, a, b in (("restore", 1_100, 1_200), ("copy", 1_200, 1_220),
                        ("step", 1_220, 1_300), ("save", 1_300, 1_400)):
        spans.add(label, a, b)
    program = [S("restore", 101, 195, 1, 1, None, 2), S("restore.read", 105, 150, 1, 2, 1, 2),
               S("restore.decode", 150, 180, 1, 3, 1, 2),
               S("restore.place", 182, 194, 1, 4, 1, 2),
               S("train.update", 250, 290, 1, 5, None, None),
               S("save", 300, 400, 1, 6, None, 3), S("save.encode", 300, 380, 1, 7, 6, 3),
               S("save.wait_staged", 310, 330, 1, 8, 7, 3),
               S("save.l1_sync", 380, 400, 1, 9, 6, 3), S("flush", 0, 1_000, 2, 10, None, 3)]
    return spans, program


def test_nest_labels_each_part_by_the_innermost_program_span():
    spans, program = made_up()
    got = program_spans.nest(spans, program, thread=1)
    assert got._offset == spans._offset
    assert got.items == [
        ("restore", 1_100, 1_101), ("restore/restore", 1_101, 1_105),
        ("restore/restore.read", 1_105, 1_150), ("restore/restore.decode", 1_150, 1_180),
        ("restore/restore", 1_180, 1_182), ("restore/restore.place", 1_182, 1_194),
        ("restore/restore", 1_194, 1_195), ("restore", 1_195, 1_200),
        ("copy", 1_200, 1_220),
        ("step", 1_220, 1_250), ("step/train.update", 1_250, 1_290), ("step", 1_290, 1_300),
        ("save/save.encode", 1_300, 1_310), ("save/save.wait_staged", 1_310, 1_330),
        ("save/save.encode", 1_330, 1_380), ("save/save.l1_sync", 1_380, 1_400)]
    # only the given thread's spans cut; without them, nothing changes
    assert program_spans.nest(spans, program, thread=2).items == [
        (f"{label}/flush", a, b) for label, a, b in spans.items]
    assert program_spans.nest(spans, program, thread=3).items == spans.items
    assert program_spans.nest(spans, [], thread=1).items == spans.items


@pytest.mark.parametrize("events", [
    [],
    [(1_120, 1_160, "k"), (1_230, 1_260, "k"), (1_305, 1_320, "k")],
    [(1_000, 1_500, "k")],
], ids=["all idle", "some busy", "all busy"])
def test_reduce_gives_each_label_the_sum_of_its_parts(events):
    spans, program = made_up()
    t0, t1 = 1_050, 1_450
    plain = trace.reduce(events, spans, t0, t1)
    nested = trace.reduce(events, program_spans.nest(spans, program, thread=1), t0, t1)
    assert nested.busy_s == plain.busy_s and nested.op_s == plain.op_s
    for label, idle in plain.idle_s.items():
        parts = sum(v for k, v in nested.idle_s.items() if k.split("/")[0] == label)
        assert parts == pytest.approx(idle, rel=1e-12, abs=1e-15), label
    assert set(k.split("/")[0] for k in nested.idle_s) == set(plain.idle_s)


def test_within_sums_the_named_spans_under_each_top_span():
    program = [S("restore", 0, 100, 1, 1, None, 2), S("restore.base", 10, 40, 1, 2, 1, 1),
               S("restore.read", 12, 20, 1, 3, 2, 1), S("restore.decode", 20, 38, 1, 4, 2, 1),
               S("restore.decode", 50, 80, 1, 5, 1, 2), S("restore", 200, 300, 1, 6, None, 2),
               S("restore.decode", 210, 220, 1, 7, 6, 2)]
    got = program_spans.within(program, "restore", ("restore.base", "restore.decode"))
    assert got == pytest.approx([60e-9, 10e-9])
    assert program_spans.within(program, "restore", ("restore.place",)) == [0.0, 0.0]
    assert program_spans.within([], "restore", ("restore.place",)) == []


def test_covered_gives_each_benchmark_span_its_share_under_the_program():
    spans, program = made_up()
    nested = program_spans.nest(spans, program, thread=1)
    got = phases.covered(spans, nested, "restore", 1_050, 1_450)
    assert got == pytest.approx([(45 + 30 + 12) / 100])
    assert phases.covered(spans, nested, "save", 1_050, 1_450) == pytest.approx([1.0])
    assert phases.covered(spans, nested, "save", 1_050, 1_350) == []


def test_a_program_without_a_recorder_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.utils.telemetry", None)
    assert program_spans.recorder() is None


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_of_program_spans_on_the_smoke_cells(cell, monkeypatch):
    """A traced run (no device here: the profiler's start and stop stand
    in for it, torch's flag of a running profiler alone) fills the
    program's recorder, and ``phases.py`` names the idle by its spans; an
    untraced one gives no reading, even with the recorder switched on
    around it."""
    from torch.autograd import profiler

    from repro_torch.utils import telemetry

    monkeypatch.setattr(trace, "start", lambda: profiler._set_is_profiler_enabled(True))
    monkeypatch.setattr(trace, "stop", lambda prof: profiler._set_is_profiler_enabled(False)
                        or [])
    found = {}
    monkeypatch.setattr(trace, "reduce", phases.reducer(found))
    keep = {}
    res = run_smoke(cell, keep, traced=True)
    assert not telemetry.enabled()
    rec = keep["record"]
    assert res["correct"] is True, res["checks"]
    program = program_spans.spans(rec)
    assert program
    for name in READERS[cell]:
        v = bench.load_reader("metrics", name)(rec)
        assert v is not None and v > 0, name
        assert res["metrics"][name]["value"] == v
    seconds = dict(found["program_spans"])
    assert set(seconds) == {s.name for s in program}
    idle, counts = dict(found["idle_gaps"]), found["program_counts"]
    if cell == "xlstm-350m.resume":
        assert len([s for s in program if s.name == "restore"]) == len(rec.restores)
        for part in ("restore.read", "restore.decode", "restore.place"):
            assert idle.get(f"restore/{part}", 0) > 0, part
        assert counts["restore.h2d_bytes"] > 0
        assert len(found["covered"]["restore"]) == len(rec.restores)
        assert min(found["covered"]["restore"]) > 0.5
    else:
        assert {s.step for s in program if s.name == "flush"} == {s["step"] for s in rec.saves}
        for part in ("save.encode", "save.l1_sync"):
            assert idle.get(f"save/{part}", 0) > 0, part
        assert "stage.device_pass" in seconds and counts["stage.dirty_chunks"] > 0
        assert len(found["covered"]["save"]) == len(rec.saves)
        assert min(found["covered"]["save"]) > 0.5
    assert "step/train.loss_and_grads" in idle and "step/train.update" in idle

    keep = {}
    telemetry.enable()
    try:
        res = run_smoke(cell, keep)
    finally:
        telemetry.disable()
        telemetry.drain()
    assert program_spans.spans(keep["record"]) == []
    assert "breakdown" not in res
    for name in READERS[cell]:
        assert bench.load_reader("metrics", name)(keep["record"]) is None, name
