"""One-command consistency report over the bundled configs (BASELINE.md's
metrics table).

Counterpart of ``scripts/parity_report.py``: every bundled config runs end
to end through ``cli.run_config`` (keyframe translation, then propagation
and blending, forced on) and the BASELINE.md metrics are computed for both
the input clip and the translated clip of each: the flow-warp error and
the frame-to-frame similarity (CLIP's where a CLIP vision checkpoint sits
beside ``gmflow_path``, else a pixel-cosine proxy).  Writes the table as
markdown (``--md``) and the rows as JSON (``--out``), both under the
git-ignored ``output/`` by default.  Runs on the card unless ``--device
cpu`` is given.  Without checkpoints the weights are seeded random ones,
and the numbers are regression bounds, not quality parity.

    python -m fresco_torch.scripts.parity_report                          # all four configs
    python -m fresco_torch.scripts.parity_report --configs config/config_music.yaml

Useful flags:
    --reuse   reuse save_path/metrics.json from a previous run where present
              (per config) instead of running the pipeline
    --tiny    tiny random-weight models (smoke runs)
    --random-aux-weights   seeded random weights for the control detector and
              EGNet where their checkpoints are missing, so that they run
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

#: the repo root (this file is fresco_torch/scripts/parity_report.py)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fmt(v) -> str:
    return f"{v:.4g}" if isinstance(v, (int, float)) else "—"


def make_table(rows: list[dict]) -> str:
    """Markdown table of BASELINE.md's metrics-to-establish row."""
    lines = [
        "| Config | warp error (input) | warp error (translated) | "
        "frame similarity (input) | frame similarity (translated) | "
        "similarity metric | wall (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        inp, tr = r.get("input") or {}, r.get("translated") or {}
        is_clip = tr.get("frame_similarity_is_clip",
                         inp.get("frame_similarity_is_clip"))
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} |".format(
                r["config"],
                _fmt(inp.get("warp_error")),
                _fmt(tr.get("warp_error")),
                _fmt(inp.get("frame_similarity")),
                _fmt(tr.get("frame_similarity")),
                "CLIP" if is_clip else "pixel proxy",
                _fmt(r.get("wall_s")),
            )
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="*", default=None,
                    help="config YAMLs (default: config/config_*.yaml)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random-weight models (smoke runs)")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse existing save_path/metrics.json when present")
    ap.add_argument("--frame-count", type=int, default=None,
                    help="cap input frames per config (smoke runs)")
    ap.add_argument("--resolution", type=int, default=None,
                    help="override the working resolution (smoke runs; the "
                         "metrics are defined at the configs' own resolution)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override num_inference_steps (smoke runs); warmup "
                         "is rescaled proportionally")
    ap.add_argument("--out-root", default=None,
                    help="rebase each config's save_path under this dir "
                         "(hermetic smoke runs)")
    ap.add_argument("--out", default="output/parity/report.json")
    ap.add_argument("--md", default="output/parity/PARITY.md")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--random-aux-weights", action="store_true",
                    help="seeded random weights for the control detector and "
                         "EGNet where their checkpoints are missing")
    args = ap.parse_args(argv)

    from fresco_torch.cli import run_config
    from fresco_torch.core.config import load_config

    cfg_paths = args.configs or sorted(
        glob.glob(os.path.join(REPO, "config", "config_*.yaml"))
    )

    rows = []
    for path in cfg_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        config = load_config(path)
        # the metrics are defined on the fully blended clip: propagation on
        # even for configs that ship run_ebsynth=false
        config = config.replace(run_ebsynth=True)
        if args.frame_count:
            config = config.replace(frame_count=args.frame_count)
        if args.resolution:
            config = config.replace(resolution=args.resolution)
        if args.steps:
            frac = config.num_warmup_steps / max(config.num_inference_steps, 1)
            config = config.replace(
                num_inference_steps=args.steps,
                num_warmup_steps=int(args.steps * frac),
            )
        if args.out_root:
            config = config.replace(
                save_path=os.path.join(args.out_root, name) + os.sep
            )
        mpath = os.path.join(config.save_path, "metrics.json")
        t0 = time.time()
        if args.reuse and os.path.exists(mpath):
            with open(mpath) as f:
                report = json.load(f)
            print(f"[parity] {name}: reusing {mpath}", flush=True)
        else:
            print(f"[parity] {name}: running end-to-end...", flush=True)
            report = run_config(config, tiny=args.tiny, device=args.device,
                                random_aux_weights=args.random_aux_weights)
        rows.append({
            "config": name,
            "wall_s": round(time.time() - t0, 1),
            **(report or {}),
        })

    out_path, md_path = (os.path.join(REPO, p) for p in (args.out, args.md))
    for p in (out_path, md_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    table = make_table(rows)
    header = (
        "# Quality-parity report (BASELINE.md metrics)\n\n"
        "Flow-warp error (lower = more temporally consistent) and "
        "frame-to-frame similarity (higher = more consistent) for the "
        "input vs the translated clip of each bundled config.  Parity "
        "means the translated scores track the reference's translated "
        "scores; with no checkpoints these are regression numbers on "
        "random-weight translations.\n\n"
    )
    with open(md_path, "w") as f:
        f.write(header + table + "\n")
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=2)
    print(table)
    print(f"[parity] wrote {args.md} and {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
