"""Run one cell of the benchmark traced, with its idle gaps named by the
program's own phases.

    python3 ckpt_bench/phases.py --workload xlstm-350m.resume --seed 7 --seconds 51

from the root of a checkout runs ``run.py --trace 1`` in this process and
prints its lines unchanged. Before the device trace is reduced, it also
cuts the benchmark's spans by the program's spans of the loop's thread
(``program_spans.nest``) and reduces the trace once more. After the
result line it prints one more JSON object, under ``phases``:

* ``idle_gaps``: the idle under each ``<benchmark label>/<program
  span>`` (``restore/restore.decode``, ``step/train.update``;
  ``restore/restore``: inside the program's span, under none of its
  children), or the plain label where no program span was open;
* ``program_spans``: the seconds under each program span name, every
  thread; ``program_counts``: the program's counters of the window;
* ``covered``: for each benchmark ``restore`` and ``save`` span, the
  share of it under the program's ``restore.*`` or ``save.*`` spans.

A program without a recorder gives a run.py line alone.
"""
import json
import sys
import threading
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from ckpt_bench import run  # noqa: E402  (first: it sets the environment torch reads)
from ckpt_bench import program_spans, trace  # noqa: E402


def covered(spans: trace.Spans, nested: trace.Spans, label: str, t0: int, t1: int) -> list:
    """For each benchmark span ``label`` in the window, the share of it
    under the program's ``<label>.*`` spans."""
    parts = [(s, e) for lab, s, e in nested.items if lab.startswith(f"{label}/{label}.")]
    out = []
    for lab, a, b in spans.items:
        if lab == label and t0 <= a and b <= t1 and b > a:
            inside = sum(max(0, min(e, b) - max(s, a)) for s, e in parts)
            out.append(inside / (b - a))
    return out


def reducer(found: dict, plain=trace.reduce):
    """``trace.reduce`` that also fills ``found`` with the phases above;
    the trace it returns is ``plain``'s, as run.py reports it."""

    def reduce(events, spans, t0, t1):
        program, counts = program_spans.collect()
        program = [s for s in program if t0 <= s.start_ns + spans._offset <= t1]
        nested = program_spans.nest(spans, program, threading.get_ident())
        seconds = defaultdict(float)
        for s in program:
            seconds[s.name] += (s.end_ns - s.start_ns) / 1e9
        found.update(
            idle_gaps=trace.top(plain(events, nested, t0, t1).idle_s, 24),
            program_spans=trace.top(seconds, len(seconds)), program_counts=counts,
            covered={k: covered(spans, nested, k, t0, t1) for k in ("restore", "save")})
        return plain(events, spans, t0, t1)

    return reduce


def main(argv=None) -> int:
    found = {}
    trace.reduce = reducer(found)
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(argv + ["--trace", "1"])
    if rc == 0 and found.get("program_spans"):
        print(json.dumps({"phases": found}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
