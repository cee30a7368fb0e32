"""``BENCHMARK.json`` against the contract's shape, and the result line a
run prints, with the profiler off and on."""
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_file(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(core.ROOT, c["file"]))
        spec = core.load_json(core.ROOT, c["file"])
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"] == []
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(core.BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(core.BENCH_DIR, "limits", f"{w['name']}.json"))
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert os.path.exists(os.path.join(core.BENCH_DIR, "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        e2e = {m["name"] for m in core.cell_metrics(bench, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(bench, cell, "per_layer")
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(bench, tiny_run, traced):
    cell = bench["workloads"][0]["name"]
    r = tiny_run(cell, traced)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    want = core.cell_metrics(bench, cell, "per_layer" if traced else "end_to_end")
    assert set(line["metrics"]) <= {m["name"] for m in want}
    for name, v in line["metrics"].items():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
        assert v["unit"] == next(m["unit"] for m in want if m["name"] == name)
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    else:
        assert {m["name"] for m in want} == set(line["metrics"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run fails and prints no result line."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sd15_hed_music.keyframes", "--seed",
                        "2147483700", "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the files under its paths has no program: no result."""
    import shutil

    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sd15_hed_music.keyframes", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""

