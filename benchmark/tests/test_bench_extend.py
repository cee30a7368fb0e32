"""A new cell comes from new files and entries alone: a configuration
file, a traffic file of a new kind with its generator module, a metric
reader and a limits file, with their ``BENCHMARK.json`` entries, run with
no other edit."""
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import core


def test_new_files_make_a_new_cell(tmp_path, tiny):
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(core.ROOT, "fresco_torch"), tmp_path / "fresco_torch")
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    b = tmp_path / "benchmark"
    spec = core.load_json(core.ROOT, bench["configs"][0]["file"])
    spec.update(name="sd15_hed_music_short", keyframes=spec["keyframes"][:6])
    (b / "configs" / "sd15_hed_music_short.json").write_text(json.dumps(spec))
    (b / "harness" / "keyframes_counted.py").write_text(
        "from benchmark.harness.keyframes import Keyframes\n\n\n"
        "class Traffic(Keyframes):\n"
        "    def window(self, seconds):\n"
        "        return {**super().window(seconds), 'counted_calls': self.calls}\n")
    (b / "traffic" / "keyframes_one.json").write_text(json.dumps({"kind": "keyframes_counted",
                                                                  "compare_batches": 1}))
    (b / "metrics" / "window_calls.py").write_text("def read(ctx):\n    return ctx.stats['counted_calls']\n")
    (b / "limits" / "sd15_hed_music_short.keyframes_one.json").write_text(json.dumps({"mean_gap": 1.0,
                                                                                      "quadrant_gap": 1.0}))
    cell = "sd15_hed_music_short.keyframes_one"
    bench["configs"].append({"name": "sd15_hed_music_short", "source": "a test", "reduced": [], "why": "a test",
                             "file": "benchmark/configs/sd15_hed_music_short.json"})
    bench["workloads"].append({"name": cell, "config": "sd15_hed_music_short", "traffic": "keyframes_one",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "window_calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "keyframe stage", "moves": "keyframes_per_s",
                               "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch\nsys.path.insert(0, '.')\nfrom benchmark.harness import core\n"
            f"r = core.run(core.load_json('BENCHMARK.json'), {cell!r}, 4, 0.5, True, torch.device('cpu'), "
            f"overrides=json.loads({json.dumps(tiny)!r}))\nprint(json.dumps(r))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["metrics"]["window_calls"]["value"] >= 1
    assert r["attempted"] <= 6
