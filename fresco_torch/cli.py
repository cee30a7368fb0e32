"""Command line: one config end to end, keyframes then propagation.

Counterpart of ``fresco_tpu/cli.py`` (reference run_fresco.py:302-318):

    python -m fresco_torch.cli <config.yaml> [--tiny] [--keyframes-only] [--device cpu]

Keyframe translation writes save_path/video/ and save_path/keys/; with
``run_ebsynth`` the propagation stage writes save_path/blend/ and
save_path/blend.mp4 (at the input's frame rate, else 30), and the
run writes phases.json (keyframe and propagation phase seconds) and
metrics.json (warp error and frame similarity of the blended clip and of
the input).  Propagation and the metrics take the flows of the bundle's
GMFlow when its checkpoint exists at ``gmflow_path``, else Farneback's
through OpenCV, as the JAX CLI does; with neither, the bundle's GMFlow
with random weights (``FrescoPipeline.consistency_flow_fn``).  Intervals
propagate in waves over every visible card when ``max_process`` > 1.  The
frame similarity is CLIP's where a CLIP vision checkpoint sits beside
``gmflow_path``.  Decoding the .mp4 and writing blend.mp4 need ``cv2``.
The device defaults to the card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

from fresco_torch.core.config import load_config


def run_config(config, tiny: bool = False, keyframes_only: bool = False, reuse_synthesis: bool = False,
               sync_phases: bool = False, device=None, random_aux_weights: bool = False):
    """Keyframes, then (with ``config.run_ebsynth``) propagation and the
    consistency report.  Returns the report (also in metrics.json), or
    None when propagation was skipped.  ``random_aux_weights``: the control
    detector and EGNet get seeded random weights where their checkpoints
    are missing (``build_models``), so that they run without them.

    A ``mesh_shape`` of more than one rank joins the process group that
    torchrun's (or Slurm's) variables name (``parallel.distributed``): every
    rank translates the keyframes, and rank 0 alone writes them, propagates
    and reports (the other ranks return None), with a whole GMFlow that
    every rank helped put together from the split one first."""
    from fresco_torch.parallel import distributed
    from fresco_torch.pipeline.runner import FrescoPipeline, build_models

    if math.prod(config.mesh_shape) > 1:
        distributed.initialize()  # without a rendezvous the pipeline raises, naming torchrun (F23)
    t0 = time.time()
    kw = ({"bundle": build_models(config, tiny=tiny, seed=config.seed, device=device, random_aux_weights=True)}
          if random_aux_weights else {})
    pipe = FrescoPipeline(config, tiny=tiny, device=device, **kw)
    pipe.sync_phases = sync_phases
    print(f"[fresco_torch] model build: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    keys = pipe.translate_keyframe_files(reuse=reuse_synthesis)
    print(f"[fresco_torch] keyframe translation: {time.time() - t0:.1f}s", flush=True)
    if keyframes_only or not config.run_ebsynth:
        return None
    if math.prod(config.mesh_shape) > 1:
        pipe.whole_gmflow()  # every rank together: rank 0 runs GMFlow alone from here
    if not distributed.is_main_process():
        return None

    from fresco_torch.propagate.video_blend import blend_video, get_fps

    prop_phases: dict = {}
    # Poisson fusion always, whatever config.use_poisson says: the reference
    # CLI passes poisson=True (fresco_tpu/cli.py:72)
    blend_dir = blend_video(config.save_path, key_ind=keys, key_dir="keys",
                            output=os.path.join(config.save_path, "blend.mp4"),
                            fps=get_fps(config.file_path) or 30, n_proc=config.max_process,
                            flow_fn=pipe.consistency_flow_fn(), poisson=True,
                            n_devices="auto" if config.max_process > 1 else 1, reuse_synthesis=reuse_synthesis,
                            device=pipe.device, timers_out=prop_phases)
    phases = {"keyframes": {k: round(v, 3) for k, v in pipe.phases.times.items()},
              "propagation": {k: round(v, 3) for k, v in prop_phases.items()}}
    with open(os.path.join(config.save_path, "phases.json"), "w") as f:
        json.dump(phases, f, indent=2)
    report = {"translated": pipe.evaluate_consistency(blend_dir),
              "input": pipe.evaluate_consistency(os.path.join(config.save_path, "video"))}
    with open(os.path.join(config.save_path, "metrics.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[fresco_torch] consistency metrics: {report}")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description="FRESCO video translation (PyTorch + CUDA)")
    parser.add_argument("config_path", type=str, help="YAML configuration file")
    parser.add_argument("--tiny", action="store_true", help="tiny random-weight models (smoke runs)")
    parser.add_argument("--keyframes-only", action="store_true", help="skip full-video propagation")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: the card)")
    opt = parser.parse_args(argv)
    config = load_config(opt.config_path)
    print("=" * 80)
    for k, v in sorted(vars(config).items()):
        print(f"{k}: {v}")
    print("=" * 80)
    run_config(config, tiny=opt.tiny, keyframes_only=opt.keyframes_only, device=opt.device)
    print("Done")


if __name__ == "__main__":
    main()
