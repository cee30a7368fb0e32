"""Interleaved A/B of the keyframe stage's schedule on the GPU: serial prep
(``FrescoPipeline.translate_keyframes``) against batch k+1's prep
overlapped with batch k's denoise (the JAX package's prep thread,
rebuilt here on a worker thread and a CUDA stream of its own).

The cell is chip_smoke.py's end-to-end run: 41 frames at 512x512,
config_music's settings at full SD1.5 width with random weights, GMFlow
flows, HED control and EGNet background smoothing; 11 keyframes in two
batches.  The keyframes are selected once.  After one warm-up run the
two schedules alternate as overlapped, serial, serial, overlapped, ...
(``--pairs`` pairs), phases unsynchronized in both.  Prints each run's
wall, each schedule's mean and spread, the largest difference between
the two schedules' keyframes, and the card's name and power limit.  Run
from the root of a checkout on a machine with a CUDA card:

    python3 ab_prep_overlap.py [--seed N] [--pairs P]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs


def translate_overlapped(pipe, frames, key_ind):
    """``translate_keyframes`` with batch k+1's prep on a thread and a CUDA
    stream while batch k denoises; batch k+1's denoise waits on an event
    recorded at the end of its prep."""
    batches = pipe.keyframe_batches(frames, key_ind)
    dev = pipe.device
    gens = [torch.Generator(device=dev).manual_seed(pipe.config.seed) for _ in batches]
    stream = torch.cuda.Stream(dev)

    def prep(k):
        _, imgs, prompts, negs = batches[k]
        with torch.cuda.stream(stream):
            out = pipe._prepare_batch(imgs, prompts, negs, None, generator=gens[k])
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    result, record = {}, None
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(prep, 0)
        for bi, (sub, *_rest) in enumerate(batches):
            prepared, ready = fut.result()
            if bi + 1 < len(batches):
                fut = ex.submit(prep, bi + 1)
            torch.cuda.current_stream(dev).wait_event(ready)
            latents, record = pipe._run_batch(prepared, record, bi > 0, None, generator=gens[bi])
            images = pipe.decode(latents)  # synchronizes: `prepared` is no longer read after this
            bias = 2 if bi > 0 else 0
            for ind, num in enumerate(sub):
                result[num] = images[ind + bias]
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from fresco_torch.pipeline.keyframes import select_keyframes_from_frames
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi unavailable (rc {smi.returncode})")
    dev = torch.device("cuda", 0)
    cfg = cs.music_config(mininterv=cs.E2E_MININTERV, maxinterv=cs.E2E_MAXINTERV)
    pipe = FrescoPipeline(cfg, build_models(cfg, seed=args.seed, device=dev, random_aux_weights=True))
    frames, _, _ = cs.make_inputs(args.seed, cs.E2E_FRAMES, 512)
    key_ind = select_keyframes_from_frames(frames, cfg.mininterv, cfg.maxinterv)
    print(f"{len(frames)} frames 512x512, keyframes {key_ind}")
    arms = {"serial": lambda: pipe.translate_keyframes(frames, key_ind),
            "overlapped": lambda: translate_overlapped(pipe, frames, key_ind)}

    def timed(arm):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        keys = arms[arm]()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, keys

    wall, keys = timed("serial")
    print(f"warm-up serial: {wall:.3f} s")
    order = ["overlapped", "serial", "serial", "overlapped"] * (args.pairs // 2) + \
        ["overlapped", "serial"] * (args.pairs % 2)
    walls = {"serial": [], "overlapped": []}
    diff = 0
    for arm in order:
        wall, out = timed(arm)
        walls[arm].append(wall)
        diff = max(diff, max(int(np.abs(out[k].astype(int) - keys[k]).max()) for k in key_ind))
        print(f"{arm:10s}: {wall:.3f} s")
    summary = {arm: {"mean_s": float(np.mean(w)), "min_s": min(w), "max_s": max(w), "runs": w}
               for arm, w in walls.items()}
    for arm, s in summary.items():
        print(f"{arm:10s}: mean {s['mean_s']:.3f} s, spread {s['min_s']:.3f}-{s['max_s']:.3f} s over {len(s['runs'])}")
    print(f"overlapped - serial: {summary['overlapped']['mean_s'] - summary['serial']['mean_s']:+.3f} s; "
          f"keyframes max |d| between runs {diff} levels")
    print(json.dumps({"ab_prep_overlap": summary, "max_abs_diff_levels": diff}))


if __name__ == "__main__":
    main()
