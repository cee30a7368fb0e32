"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names its generator,
the module ``benchmark/harness/<kind>.py`` and its class ``Traffic``), the limits of its check (``benchmark/limits/<cell>.json``)
and each per-layer metric's reader (``benchmark/metrics/<metric>.py``, a
``read(ctx)`` that returns a number or None).  A run: set-up (weights from
the seed, kernels loaded, every shape warmed up), the window of
``--seconds`` (under ``torch.profiler`` with ``--trace 1``), then the
check against the frozen reference once the program is freed.  The last
line of standard output is the result; the numbers compared, each with its
limit, are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import types

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
KIND_NAME = re.compile(r"[a-z][a-z0-9_]{0,63}")
FORBIDDEN = ("jax", "jaxlib", "flax", "fresco_tpu")


def exact_float32() -> None:
    """The configuration's float32 stays float32: no TF32 in the program's
    float32 products and convolutions (the detectors, GMFlow, the gram)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit_w() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def read_clip(spec: dict) -> list:
    """The configuration's clip as uint8 RGB frames at its working size
    (OpenCV decodes; LANCZOS4 grows a frame, AREA shrinks it)."""
    import cv2

    clip = spec["clip"]
    cap = cv2.VideoCapture(os.path.join(ROOT, clip["file"]))
    frames = []
    while len(frames) < clip["frames"]:
        ok, bgr = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]
        if (h, w) != (clip["height"], clip["width"]):
            grow = clip["height"] * clip["width"] > h * w
            rgb = cv2.resize(rgb, (clip["width"], clip["height"]),
                             interpolation=cv2.INTER_LANCZOS4 if grow else cv2.INTER_AREA)
        frames.append(rgb)
    cap.release()
    if len(frames) != clip["frames"]:
        raise RuntimeError(f"{clip['file']}: {len(frames)} frames decoded, {clip['frames']} expected")
    return frames


def metric_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end or per-layer metrics (``kind``: the key)."""
    e2e_here = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e_here]
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e_here else [])]


def make_traffic(bench: dict, cell_name: str, seed: int, device, frames=None, overrides: dict | None = None):
    """(cell, spec, traffic, the traffic kind's object) of ``cell_name``;
    ``overrides`` replaces parts of the configuration (the tests' tiny sizes)."""
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
    if cell is None:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    spec = load_json(ROOT, cfg["file"])
    for key, val in (overrides or {}).items():
        spec[key] = {**spec[key], **val} if isinstance(val, dict) and key != "widths" else val
    traffic = load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    frames = read_clip(spec) if frames is None else frames
    return cell, spec, traffic, traffic_kind(traffic["kind"])(spec, traffic, seed, device, frames)


def traffic_kind(kind: str):
    """The generator class ``Traffic`` of the module ``benchmark/harness/<kind>.py``."""
    if not KIND_NAME.fullmatch(kind):
        raise ValueError(f"traffic kind {kind!r} is not a module name")
    return importlib.import_module(f"benchmark.harness.{kind}").Traffic


def run(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool, device, overrides=None) -> dict:
    """One run of a cell on ``device``: the result's fields, and ``checks``."""
    import torch
    from torch.profiler import record_function

    from benchmark.harness.trace import Tracer

    cuda = device.type == "cuda"
    exact_float32()
    cell, spec, traffic, kind = make_traffic(bench, cell_name, seed, device, overrides=overrides)
    limits = load_json(BENCH_DIR, "limits", f"{cell_name}.json")
    kind.setup(traced)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()
    with Tracer(traced) as tracer:
        with record_function("bench::window"):
            stats = kind.window(seconds)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tracer.close()
        if traced:
            print(f"benchmark: trace read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    values = {**kind.end_to_end(stats), "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": stats["attempted"], "failed": 0, "metrics": {}, "device": dev}
    power = power_limit_w() if cuda else "none"
    dev["power_limit_w"] = power
    if traced:
        trace = tracer.trace
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        ctx = types.SimpleNamespace(spec=spec, traffic=traffic, cell=cell, stats=stats, trace=trace,
                                    power_limit_w=power)
        for m in cell_metrics(bench, cell_name, "per_layer"):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": trace.top_ops(10), "idle_gaps": trace.idle_gaps(10)}
    else:
        for m in cell_metrics(bench, cell_name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    print(f"benchmark: {cell_name} seed {seed}: window {stats['wall_s']:.3f} s, setup {setup_s:.3f} s, "
          f"peak {peak / 2**30:.3f} GiB, power limit {power} W, "
          + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
          + f"; batches ended at {stats.get('batch_ends_s')} s", file=sys.stderr)
    kind.release()
    t0 = time.perf_counter()
    numbers = kind.check()
    print(f"benchmark: check took {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    others = {name: v for name, v in numbers.items() if name not in limits}
    if others:
        print("benchmark: read but not compared in this cell: "
              + ", ".join(f"{k} {v!r}" for k, v in others.items()), file=sys.stderr)
    result["checks"] = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    result["correct"] = all(numbers[name] <= limit for name, limit in limits.items())
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if importlib.util.find_spec("fresco_torch") is None:
        return fail("the program (fresco_torch) is not in this checkout")
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        return fail(f"modules of JAX or of the JAX package are loaded: {bad}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
