"""Where a keyframe batch's time goes on the GPU, at two frame sizes.

Builds config_music's models at full width (HED and EGNet with seeded
random weights), then for each frame size runs one batch of 8 keyframes
(chip_smoke.make_inputs frames, the bundle's GMFlow) through
FrescoPipeline._translate_batch and decode once to warm up, once timed
with the profiler off and once under torch.profiler.  Prints for each
size: the walls, the device's busy and idle share (kernel time over the
profiled wall), the device time under each ``fresco::`` range of the
sampler, the device time by kernel, and the launches of the three
keyframe kernels.  Run from the root of a checkout on a machine with a
CUDA card:

    python3 profile_keyframes.py [--seed N]
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import torch

import chip_smoke as cs

SIZES = ((512, 512), (512, 640))  # HxW: the smoke test's keyframe batch and config_music's frames
TOP = 12                          # kernels listed by device time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from fresco_torch import kernels
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    kernels.load()
    dev = torch.device("cuda", 0)
    n = 8
    cfg = cs.music_config(batch_size=n)
    pipe = FrescoPipeline(cfg, build_models(cfg, seed=args.seed, device=dev, random_aux_weights=True))
    prompts, negs = cs.prompts_for(cfg, n)
    for h, w in SIZES:
        frames, _, _ = cs.make_inputs(args.seed, n, (h, w))

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latents, _ = pipe._translate_batch(frames, prompts, negs, None, False)
            pipe.decode(latents)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        wall0 = run()
        kernels.reset_launches()
        wall = run()
        launches = {k: v for k, v in kernels.launches().items() if k in ("flash_attn_fwd", "sign_gram", "bmm")}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = run()
        by_kernel: dict[str, list] = defaultdict(lambda: [0.0, 0])
        for ev in prof.events():
            # the fresco:: ranges show on the device timeline too; they are not kernels
            if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.name.startswith("fresco::"):
                by_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3  # ms
                by_kernel[ev.name][1] += 1
        busy_ms = sum(v[0] for v in by_kernel.values())
        ranges = {e.key: e.device_time_total / 1e3 for e in prof.key_averages() if e.key.startswith("fresco::")}
        print(f"batch {n} x {h}x{w}: wall {wall0:.3f} s (first), {wall:.3f} s (profiler off), {wall_prof:.3f} s "
              f"(profiled); launches {launches}; {smi.stdout.strip()}")
        print(f"  device kernel time {busy_ms / 1e3:.3f} s of {wall_prof:.3f} s: busy share "
              f"{busy_ms / 1e3 / wall_prof:.3f}, idle share {1 - busy_ms / 1e3 / wall_prof:.3f}")
        print("  device ms under each range (nested ranges overlap): "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(ranges.items(), key=lambda kv: -kv[1])))
        print(f"  {'device ms':>10s} {'share':>6s} {'count':>7s}  kernel")
        for name, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
            print(f"  {ms:10.2f} {ms / busy_ms:6.3f} {cnt:7d}  {name[:110]}")


if __name__ == "__main__":
    main()
