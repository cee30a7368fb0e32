"""Wrapper-call time of row_gather and patch_eval: this tree's wrappers
against another checkout's, alternately, on one card.

    python3 launch_cost.py --other DIR [--out FILE]

``DIR`` is a checkout of another commit (say the parent, unpacked with
``git archive``).  Its ``fresco_torch/propagate/gather.py`` and
``patch_eval.py`` are loaded beside this tree's under other names; they
import this tree's ``fresco_torch.kernels``, so both sides launch the same
compiled kernels on the same inputs and differ only in the wrappers'
Python (the device guard, the counts).  Each side is timed as the kernels
line of ``chip_smoke.py`` times a wrapper call (``chip_smoke.timed``), at
the main path's largest shape and at a small one where the host sets the
pace, in ROUNDS rounds whose order alternates (other, this; this, other;
...).
Prints each reading and the medians, and writes them as JSON to ``--out``.
Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs

ROUNDS = 6
SEED = 0


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(dev, seed: int) -> dict:
    """(label -> (wrapper name, its arguments)): row_gather on the vote's
    table at the finest level of a 512x640 interval and at 16x20;
    patch_eval's seeded 15-candidate case at 512x640 and at 16x20."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for h, w in (cs.PROP_HW, (16, 20)):
        n = h * w
        table = torch.rand(n, 75, generator=gen, device=dev) * 255
        idx = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        out[f"row_gather {h}x{w}"] = ("gather_rows", (table, idx))
    for (h, w), radii in ((cs.PROP_HW, [160, 80, 40]), ((16, 20), [8, 4, 2])):
        src, tgt, weights, omega, nnf, deltas, *_ = cs._patch_eval_case(seed, dev, (h, w), True, (1, 2, 4), radii)
        out[f"patch_eval {h}x{w} 15 cand"] = ("patch_eval", (src, tgt, weights, omega, nnf, None, (1, 2, 4),
                                                            deltas, None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="a checkout whose wrappers this tree's are timed against")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("launch_cost.py times kernels on a card; none is visible")
    from fresco_torch import kernels
    from fresco_torch.propagate import gather, patch_eval

    base = os.path.join(args.other, "fresco_torch", "propagate")
    sides = {"this": {"gather_rows": gather.gather_rows, "patch_eval": patch_eval.patch_eval}}
    other_g, other_p = _load(os.path.join(base, "gather.py"), "other_gather"), \
        _load(os.path.join(base, "patch_eval.py"), "other_patch_eval")
    sides["other"] = {"gather_rows": other_g.gather_rows, "patch_eval": other_p.patch_eval}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    kernels.load()
    readings = {"card": card, "other": os.path.abspath(args.other), "rounds": ROUNDS, "ms": {}}
    for label, (fn, fargs) in cases(dev, SEED).items():
        a = sides["this"][fn](*fargs)
        b = sides["other"][fn](*fargs)
        same = all(torch.equal(x, y) for x, y in zip(a if isinstance(a, tuple) else (a,),
                                                     b if isinstance(b, tuple) else (b,)))
        if not same:
            raise RuntimeError(f"{label}: this tree's wrapper and the other's give different outputs")
        ms = {"this": [], "other": []}
        for r in range(ROUNDS):
            for side in (("other", "this") if r % 2 == 0 else ("this", "other")):
                ms[side].append(cs.timed(lambda: sides[side][fn](*fargs)))  # noqa: B023
        med = {side: statistics.median(v) for side, v in ms.items()}
        readings["ms"][label] = {"rounds": ms, "median": med}
        print(f"{label}: wrapper call ms, median of {ROUNDS}: other {med['other']:.4f}, this "
              f"{med['this']:.4f} ({100 * (med['this'] / med['other'] - 1):+.1f} %); rounds other "
              + ", ".join(f"{x:.4f}" for x in ms["other"]) + "; this " + ", ".join(f"{x:.4f}" for x in ms["this"])
              + f" ({card})")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
