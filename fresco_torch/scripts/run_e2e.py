"""One config end to end at full length, with per-phase walls.

Counterpart of ``scripts/run_e2e.py``: the whole clip of a config
(``config_music``: 240 frames at 640x512) through ``cli.run_config`` with
propagation forced on: keyframe translation, propagation and blending,
then the consistency metrics.  Prints the TOTAL wall and the metrics;
``phases.json`` and ``metrics.json`` land under the save path.  Runs on
the card unless ``--device cpu`` is given; there it also prints the peak
device memory and the launches of the five hand-written kernels.  The JAX
script is meant to run after ``scripts/warm_cache.py``; the port has no
compile cache to warm.

    python -m fresco_torch.scripts.run_e2e [config/config_music.yaml] [--keyframes-only]
        [--save-path DIR] [--reuse] [--sync-phases] [--random-aux-weights] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="config/config_music.yaml")
    ap.add_argument("--keyframes-only", action="store_true")
    ap.add_argument("--save-path", default=None)
    ap.add_argument("--reuse", action="store_true",
                    help="resume: reuse the keyframes, cached interval synthesis and flows (reference -ne)")
    ap.add_argument("--sync-phases", action="store_true",
                    help="synchronize the device at each phase boundary, so that the phase table reads "
                         "device time (profiling runs)")
    ap.add_argument("--random-aux-weights", action="store_true",
                    help="seeded random weights for the control detector and EGNet where their "
                         "checkpoints are missing, so that they run (without it: canny, no smoothing)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from fresco_torch import kernels
    from fresco_torch.cli import run_config
    from fresco_torch.core.config import load_config
    from fresco_torch.pipeline.runner import resolve_device

    cfg = load_config(args.config)
    kw = {"run_ebsynth": True}
    if args.save_path:
        kw["save_path"] = args.save_path
    cfg = cfg.replace(**kw)
    print(f"[e2e] config={args.config} save_path={cfg.save_path}", flush=True)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launches()
    t0 = time.time()
    report = run_config(cfg, keyframes_only=args.keyframes_only, reuse_synthesis=args.reuse,
                        sync_phases=args.sync_phases, device=args.device,
                        random_aux_weights=args.random_aux_weights)
    wall = time.time() - t0
    print(f"[e2e] TOTAL wall {wall:.1f}s ({wall / 60:.1f} min)")
    if dev.type == "cuda":
        launches = {k: v - before[k] for k, v in kernels.launches().items()}
        print(f"[e2e] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"kernel launches {launches}")
    if report is not None:
        print(f"[e2e] metrics: {report}")
    return report


if __name__ == "__main__":
    main()
