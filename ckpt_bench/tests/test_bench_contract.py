"""BENCHMARK.json against the rules it is written to, and the harness's
imports."""
import json
import re
import subprocess
import sys
import textwrap

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["ckpt_bench"] and BENCH["command"] == ["python3", "ckpt_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("group,entry", [(g, e) for g in ENTRY_KEYS for e in BENCH[g]],
                         ids=lambda x: x["name"] if isinstance(x, dict) else x)
def test_names_units_and_keys(group, entry):
    assert set(entry) - {"workloads"} == ENTRY_KEYS[group]
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer"):
        if key in entry:
            assert _text(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    elif "source" in entry:
        assert _text(entry["source"])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_has_a_cell_and_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("ckpt_bench/") and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key not in ("d_model", "d_ff")
            assert cfg["published"][key] != cfg[key]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert (ROOT / "ckpt_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "ckpt_bench" / "limits" / f"{w['name']}.json").is_file()


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "ckpt_bench" / "end_to_end" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:   # setup_s and one more in every cell
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in cells and cell in moved.get("workloads", cells)
        assert (ROOT / "ckpt_bench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_the_harness_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run of a cell at smoke sizes, in a process of its own; its
    loaded modules, compared by whole top-level name."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT / 'ckpt_bench' / 'tests')!r}]
        from conftest import run_smoke
        from ckpt_bench import bench
        res = run_smoke("whisper-small.save", seconds=0.5)
        top = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps({{"correct": res["correct"], "modules": top,
                           "forbidden": bench.forbidden_modules()}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])
    assert got["forbidden"] == []


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and ckpt_bench."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ckpt_bench", tmp_path / "ckpt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "ckpt_bench/run.py", "--workload",
                          "whisper-small.train", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    import types

    from ckpt_bench import bench

    monkeypatch.setitem(sys.modules, "reprolike", types.ModuleType("reprolike"))
    assert bench.forbidden_modules() == []   # repro_torch, reprolike: not "repro"
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert bench.forbidden_modules() == ["jax", "repro"]
