"""Interleaved A/B of two checkouts on one GPU: chip_smoke.py's keyframe
batch (phase 5) and end-to-end run (phase 11), ``--runs`` of each per
process, one process per entry of ``--order``.

Walls move by 10-25 % between processes on one card, so the two trees
alternate (by default parent, change, change, parent) and each process's
first and later runs are read apart.  Each tree builds its own kernels.
Prints every run's walls and launches, then each tree's values side by
side, and the card's name and power limit.  Run from the root of the
changed checkout, with the other tree unpacked beside it (for example
``git archive <parent> | tar -x -C scratch_parent``):

    python3 ab_trees.py --trees scratch_parent . [--order 0 1 1 0] [--runs 2] [--skip-e2e]
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys

CHILD = """
import torch, chip_smoke as cs
from fresco_torch import kernels
kernels.load()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
for _ in range({runs}):
    cs.phase_slice({seed}, dev)
for _ in range({runs_e2e}):
    cs.phase_e2e({seed}, dev)
"""

SLICE = re.compile(r"^slice: \d+ keyframes .* wall ([\d.]+) s, .* launches (\{.*\})")
E2E = re.compile(r"^e2e: \d+ frames .* keyframe stage ([\d.]+) s, propagation ([\d.]+) s, wall ([\d.]+) s, .* launches (\{.*\})")
DENOISE = re.compile(r"denoise[ _]loop ([\d.]+)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--order", nargs="+", type=int, default=[0, 1, 1, 0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    names = ("parent", "change")
    seen: dict = {n: {"slice": [], "slice_denoise": [], "keys": [], "prop": [], "e2e": [], "launches": set()}
                  for n in names}
    for proc_i, which in enumerate(args.order):
        code = CHILD.format(runs=args.runs, runs_e2e=0 if args.skip_e2e else args.runs, seed=args.seed)
        p = subprocess.run([sys.executable, "-c", code], cwd=args.trees[which], capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout[-3000:], p.stderr[-3000:])
            sys.exit(f"process {proc_i} ({names[which]}) failed with {p.returncode}")
        rec = seen[names[which]]
        for line in p.stdout.splitlines():
            if line.startswith("slice phases"):
                rec["slice_denoise"].append(float(DENOISE.search(line).group(1)))
            m = SLICE.match(line)
            if m:
                rec["slice"].append(float(m.group(1)))
                rec["launches"].add("batch " + m.group(2))
                print(f"process {proc_i} {names[which]:6s} batch wall {m.group(1)} s, denoise loop "
                      f"{rec['slice_denoise'][-1]} s, launches {m.group(2)}")
            m = E2E.match(line)
            if m:
                rec["keys"].append(float(m.group(1)))
                rec["prop"].append(float(m.group(2)))
                rec["e2e"].append(float(m.group(3)))
                rec["launches"].add("e2e " + m.group(4))
                print(f"process {proc_i} {names[which]:6s} e2e keyframe stage {m.group(1)} s, propagation "
                      f"{m.group(2)} s, wall {m.group(3)} s, launches {m.group(4)}")
    for n in names:
        r = seen[n]
        print(f"{n}: batch walls {r['slice']}, batch denoise loops {r['slice_denoise']}, e2e keyframe stages "
              f"{r['keys']}, propagations {r['prop']}, e2e walls {r['e2e']}")
        for launch in sorted(r["launches"]):
            print(f"{n}: {launch}")


if __name__ == "__main__":
    main()
