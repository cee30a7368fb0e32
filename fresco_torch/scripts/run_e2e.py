"""One config end to end at full length, with per-phase walls.

Counterpart of ``scripts/run_e2e.py``: the whole clip of a config
(``config_music``: 240 frames at 640x512) through ``cli.run_config`` with
propagation forced on: keyframe translation, propagation and blending,
then the consistency metrics.  Prints the TOTAL wall and the metrics;
``phases.json`` and ``metrics.json`` land under the save path.  Runs on
the card unless ``--device cpu`` is given; there it also prints the peak
device memory and the launches of the five hand-written kernels.  Under
torchrun with a ``mesh_shape`` of more than one rank, each rank joins the
process group before it reads its device, so its peak is its own card's,
and every rank propagates (a chain a rank, ``cli.run_config``).
``--readings PATH`` writes this process's readings as JSON (``{rank}`` in
PATH is replaced by the rank): its rank and card, TOTAL wall, peak, the
kernels' launches in all and by card, the keyframe stage's and each
batch's walls, propagation's phases and each chain's wall.  The JAX
script is meant to run after ``scripts/warm_cache.py``; the port has no
compile cache to warm.

    python -m fresco_torch.scripts.run_e2e [config/config_music.yaml] [--keyframes-only]
        [--save-path DIR] [--reuse] [--sync-phases] [--random-aux-weights] [--device cpu] [--tiny]
        [--readings PATH]

On four cards (``mesh_shape: [4, 1]`` in the YAML):

    python -m torch.distributed.run --nproc-per-node 4 --master-addr 127.0.0.1 \
        -m fresco_torch.scripts.run_e2e <config.yaml> --random-aux-weights
"""
from __future__ import annotations

import argparse
import json
import math
import os
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
    ap.add_argument("--tiny", action="store_true", help="tiny random-weight models (rehearsals on the CPU)")
    ap.add_argument("--readings", default=None, help="write this rank's readings here as JSON ({rank}: the rank)")
    args = ap.parse_args(argv)

    from fresco_torch import kernels
    from fresco_torch.cli import run_config
    from fresco_torch.core.config import load_config
    from fresco_torch.parallel import distributed
    from fresco_torch.pipeline.runner import resolve_device

    cfg = load_config(args.config)
    kw = {"run_ebsynth": True}
    if args.save_path:
        kw["save_path"] = args.save_path
    cfg = cfg.replace(**kw)
    print(f"[e2e] config={args.config} save_path={cfg.save_path}", flush=True)

    if math.prod(cfg.mesh_shape) > 1:
        # join the process group first: it makes this rank's card current, so
        # the peak below is read on the rank's own card (run_config's own
        # initialize then returns at once)
        distributed.initialize(device_type=None if args.device is None else torch.device(args.device).type)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    readings = {}
    t0 = time.time()
    report = run_config(cfg, tiny=args.tiny, keyframes_only=args.keyframes_only, reuse_synthesis=args.reuse,
                        sync_phases=args.sync_phases, device=args.device,
                        random_aux_weights=args.random_aux_weights, readings=readings)
    wall = time.time() - t0
    rank = distributed.rank()
    print(f"[e2e] rank {rank} TOTAL wall {wall:.1f}s ({wall / 60:.1f} min)")
    readings.update(rank=rank, world=distributed.world_size(), device=str(dev), wall_s=wall,
                    backend=torch.distributed.get_backend() if torch.distributed.is_initialized() else None)
    if dev.type == "cuda":
        readings.update(card=torch.cuda.get_device_name(dev), peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                        launches=kernels.launches(), launches_by_card=kernels.launches_by_card())
        print(f"[e2e] rank {rank} on {dev}: peak device memory {readings['peak_gib']:.2f} GiB; "
              f"kernel launches {readings['launches']}, by card {readings['launches_by_card']}")
    if args.readings:
        path = args.readings.format(rank=rank)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(readings, f, indent=1)
    if report is not None:
        print(f"[e2e] metrics: {report}")
    return report


if __name__ == "__main__":
    main()
