"""The flash-attention kernel's report on the GPU: what the compiler says of
each instantiation (registers, spills, shared memory), then chip_smoke.py's
flash phase (every shape against its plain version, times beside the
three-way bound, SDPA and its backends).

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 flash_report.py [--seed N] [--no-ptxas]
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import tempfile

import torch

import chip_smoke as cs
from fresco_torch import kernels


def ptxas_report() -> None:
    """Compile flash_attn.cu once more with -Xptxas -v and print, for each
    kernel instantiation, its template arguments and resource usage."""
    src = os.path.join(kernels.CSRC, "flash_attn.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin",
             "-o", os.path.join(tmp, "flash_attn.cubin"), src],
            capture_output=True, text=True)
    if proc.returncode != 0:
        cs.fail(f"nvcc -Xptxas -v failed:\n{proc.stdout}\n{proc.stderr}")
    name = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = ", ".join(re.findall(r"Li(\d+)E", m.group(1)))
            name = (f"wgmma core <DP, stages, blocks a SM> = <{args}>" if "wgmma" in m.group(1)
                    else f"mma.sync core <DP, BN, column groups> = <{args}>")
            stack = ""
        elif "bytes stack frame" in line:
            stack = line.strip()
        elif "Used" in line and name:
            print(f"ptxas {name}: {line.split('Used', 1)[1].strip()}; {stack}")
            name = None
        elif "arning" in line or "erializ" in line:
            print(f"ptxas {line.strip()[:300]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this report needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    if not args.no_ptxas:
        ptxas_report()
    kernels.load()
    print(f"build: nvcc wall {kernels.build_info.seconds:.2f} s")
    dev = torch.device("cuda", 0)
    cs.phase_flash(torch.Generator(device=dev).manual_seed(args.seed), dev)


if __name__ == "__main__":
    main()
