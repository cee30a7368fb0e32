"""Where the propagation stage's time goes on the GPU.

Runs chip_smoke.py's propagation interval (11 frames at 512x640, keys at
both ends, analytic flows, default PatchMatchConfig, histogram blend and
Poisson fusion) once to warm up, then once under torch.profiler, and
prints: the wall, the device's busy and idle share (kernel time over the
wall of the profiled run), the device time by kernel, and the launches of
the port's two propagation kernels.  Run from the root of a checkout on a
machine with a CUDA card:

    python3 profile_propagate.py [--seed N] [--top K]
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from fresco_torch import kernels
    from fresco_torch.propagate.gather import gather_rows
    from fresco_torch.propagate.patch_eval import patch_eval
    from fresco_torch.propagate.video_blend import blend_video_frames

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    kernels.load()
    dev = torch.device("cuda", 0)
    n = 11
    frames, flows, _ = cs.make_inputs(args.seed, n, cs.PROP_HW)
    truth = [cs.style_of(f) for f in frames]
    flow_fn = cs.pair_flow_fn(frames, flows, dev)

    def run():
        tm: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blend_video_frames(dict(enumerate(frames)), {0: truth[0], n - 1: truth[n - 1]}, [0, n - 1],
                           flow_fn=flow_fn, device=dev, timers_out=tm)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tm

    wall0, _ = run()
    gather_rows.launches = patch_eval.launches = 0
    wall_plain, tm = run()
    launches = {"row_gather": gather_rows.launches, "patch_eval": patch_eval.launches}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = run()
    by_kernel: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3  # ms
            by_kernel[ev.name][1] += 1
    busy_ms = sum(v[0] for v in by_kernel.values())
    print(f"propagate interval: wall {wall0:.3f} s (first run), {wall_plain:.3f} s (second run, profiler off), "
          f"{wall_prof:.3f} s (profiled); launches per run {launches}")
    print("phases of the second run (s, host wall, overlapping): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(tm.items(), key=lambda kv: -kv[1])))
    print(f"device kernel time {busy_ms / 1e3:.3f} s of the profiled {wall_prof:.3f} s: busy share "
          f"{busy_ms / 1e3 / wall_prof:.3f}, idle share {1 - busy_ms / 1e3 / wall_prof:.3f}; "
          f"{sum(v[1] for v in by_kernel.values())} kernels")
    print(f"{'device ms':>10s} {'share':>6s} {'count':>7s}  kernel")
    for name, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"{ms:10.2f} {ms / busy_ms:6.3f} {cnt:7d}  {name[:110]}")


if __name__ == "__main__":
    main()
