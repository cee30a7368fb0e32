#!/usr/bin/env python3
"""Read the numbers of a cell's check for the program and for its control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed, in one process: the program's whole call (no window), the
frozen reference's keyframes of the compared batches, and the same
reference computed in fp8 in the program's place (``harness/control.py``);
the program and the control are each read against the reference.
Prints one JSON line a seed and reading.  The benchmark's own runs never
run the control; the limits in ``benchmark/limits/`` were set from these
readings (``PERF.md`` gives them).  Needs a CUDA card.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core, keyframes  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return core.fail("needs a CUDA card")
    dev = torch.device("cuda", 0)
    core.exact_float32()
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    frames = None
    for seed in (int(s) for s in args.seeds.split(",")):
        cell, spec, traffic, kind = core.make_traffic(bench, args.workload, seed, dev, frames)
        frames = kind.frames
        n = int(traffic["compare_batches"])
        t0 = time.perf_counter()
        kind.setup()
        t1 = time.perf_counter()
        out = kind.pipe.translate_keyframes(frames, list(spec["keyframes"]), noise=kind.noise)
        t2 = time.perf_counter()
        kind.release()
        readings = {"program": (out, {"setup_s": t1 - t0, "call_s": t2 - t1})}
        t0 = time.perf_counter()
        ref = keyframes.reference_keyframes(spec, seed, frames, dev, n)
        ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        readings["control"] = (keyframes.reference_keyframes(spec, seed, frames, dev, n, control=True),
                               {"call_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        for who, (out, times) in readings.items():
            rmse = keyframes.block_gaps(out, ref, 0)
            print(json.dumps({"workload": args.workload, "seed": seed, "who": who,
                              **keyframes.check_numbers(out, ref), "pixel_rmse": max(rmse.values()),
                              "reference_s": ref_s, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
