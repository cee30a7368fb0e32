"""Standalone ebsynth-compatible command line.

Counterpart of ``fresco_tpu/propagate/ebsynth_cli.py`` (the reference's
native binary, src/ebsynth/deps/ebsynth/src/ebsynth.cpp:290-498): the same
flags, the same "-weight applies to the preceding -style/-guide" rule; it
writes the stylized PNG and the float error map ``<output>.bin`` (int64
pixel count + float32 array, the format video_blend.py:159-169 reads).

    python -m fresco_torch.propagate.ebsynth_cli \\
        -style style.png -guide src.png tgt.png -weight 6 \\
        -output out.png -searchvoteiters 12 -patchmatchiters 6 -backend cuda

``-backend cuda`` (default; ``tpu`` is read the same) runs the jump-flood
synthesizer on the card with the draws of ``TorchDraws(0)``; ``-backend
cpu`` (or ``native``) the C++ serpentine backend on the host.  The port
adds ``-device`` (default the card; ``-device cpu`` runs on the CPU).
PNG files are read and written through Pillow; ``run`` is the same work
on arrays in memory.
"""
from __future__ import annotations

import struct
import sys

import numpy as np
import torch

from fresco_torch.propagate.patchmatch import BACKEND_NAMES


def _fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(1)


def parse_args(argv: list[str]) -> dict:
    """argv -> options; exits with a message on a malformed command line."""
    style = None
    style_weight = None
    guides: list[dict] = []
    opts = dict(output="output.png", uniformity=3500.0, patchsize=5, pyramidlevels=-1, searchvoteiters=6,
                patchmatchiters=4, stopthreshold=5, extrapass3x3=False, backend="jumpflood", device=None)
    i = 0
    prev_weight_slot = None
    while i < len(argv):
        a = argv[i]
        if a == "-style":
            style = argv[i + 1]
            prev_weight_slot = "style"
            i += 2
        elif a == "-guide":
            guides.append(dict(source=argv[i + 1], target=argv[i + 2], weight=None))
            prev_weight_slot = "guide"
            i += 3
        elif a == "-weight":
            w = float(argv[i + 1])
            if prev_weight_slot == "style":
                style_weight = w
            elif prev_weight_slot == "guide":
                guides[-1]["weight"] = w
            else:
                _fail("-weight must follow -style or -guide")
            i += 2
        elif a == "-output":
            opts["output"] = argv[i + 1]
            i += 2
        elif a == "-uniformity":
            opts["uniformity"] = float(argv[i + 1])
            i += 2
        elif a in ("-patchsize", "-pyramidlevels", "-searchvoteiters", "-patchmatchiters", "-stopthreshold"):
            opts[a[1:]] = int(argv[i + 1])
            i += 2
        elif a == "-extrapass3x3":
            opts["extrapass3x3"] = True
            i += 1
        elif a == "-backend":
            b = argv[i + 1].lower()
            if b not in BACKEND_NAMES:
                _fail(f"unknown backend {b} (expected one of {', '.join(sorted(BACKEND_NAMES))})")
            opts["backend"] = BACKEND_NAMES[b]
            i += 2
        elif a == "-device":
            opts["device"] = argv[i + 1]
            i += 2
        else:
            _fail(f"unknown option {a}")
    if style is None:
        _fail("missing -style")
    if not guides:
        _fail("missing -guide")
    opts.update(style=style, style_weight=1.0 if style_weight is None else style_weight,
                guides=[dict(g, weight=1.0 if g["weight"] is None else g["weight"]) for g in guides])
    return opts


def write_error_bin(path: str, err) -> None:
    """The reference's error-map format (ebsynth.cpp:739-752 /
    video_blend.py:159-169): int64 count, then the float32 values."""
    err = np.asarray(err, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("q", err.size))
        f.write(err.tobytes())


def patch_config(opts: dict):
    from fresco_torch.propagate.patchmatch import PatchMatchConfig

    return PatchMatchConfig(patch_size=opts["patchsize"], uniformity=opts["uniformity"],
                            pm_iters=opts["patchmatchiters"], sv_iters=opts["searchvoteiters"],
                            style_weight=opts["style_weight"], num_pyramid_levels=opts["pyramidlevels"],
                            extra_pass_3x3=opts["extrapass3x3"], stop_threshold=float(opts["stopthreshold"]))


def run(style: np.ndarray, sources: list, targets: list, weights: list[float], opts: dict,
        device: torch.device | str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """One synthesis in memory: the style image and the guide pairs
    ([H, W, C] arrays, any of uint8 / float) with one weight per guide,
    ``opts`` as ``parse_args`` gives them, on ``device`` (default the
    card).  Each guide's weight is split over its channels.  Returns the
    stylized uint8 image and the float32 error map."""
    from fresco_torch.pipeline.runner import resolve_device
    from fresco_torch.propagate.patchmatch import TorchDraws, synthesize

    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    wpc = np.concatenate([np.full(s.shape[-1], w / s.shape[-1], np.float32) for s, w in zip(sources, weights)])
    out, err, _ = synthesize(t(style), t(np.concatenate(sources, -1)), t(np.concatenate(targets, -1)), t(wpc),
                             patch_config(opts), draws=TorchDraws(0, dev), backend=opts["backend"])
    return out.clamp(0, 255).to(torch.uint8).cpu().numpy(), err.float().cpu().numpy()


def main(argv=None):
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    from fresco_torch.propagate.video_blend import read_bgr, write_bgr

    out, err = run(read_bgr(opts["style"]), [read_bgr(g["source"]) for g in opts["guides"]],
                   [read_bgr(g["target"]) for g in opts["guides"]], [g["weight"] for g in opts["guides"]],
                   opts, opts["device"])
    write_bgr(opts["output"], out)
    base = opts["output"].rsplit(".", 1)[0]
    write_error_bin(base + ".bin", err)
    print(f"wrote {opts['output']} and {base}.bin")


if __name__ == "__main__":
    main()
