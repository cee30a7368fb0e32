"""Microbench of the feature optimization's GEMM shapes on the card.

Counterpart of ``scripts/bench_gemm.py``: the batched bf16 GEMM with
float32 accumulation and output (``fresco_torch.ops.gemm.bmm``, CUDA
kernel ``fresco_torch/csrc/bmm.cu``, which replaces the Pallas
``_mm_kernel``) timed with CUDA events at the TPU script's rows:

  * the flat layout  fij,fjd->fid   [8,4096,4096] x [8,4096,1280];
  * the guidance layout fij,kfjc->kfic  with x [2,8,4096,640];
  * one [4096,4096] x [4096,1280];
  * the gram build [16,1024,320] x [16,320,4096];

each beside ``torch.matmul`` (``torch.bmm`` for the 3-D rows) on the
same bf16 operands (the library time; its output is bf16), with the
achieved TFLOP/s and the card's name and power limit.

    python3 -m fresco_torch.scripts.bench_gemm [--iters N]

On the pipeline's path the kernel is the sign-gram pair's apply; the
dense warp and GMFlow stay ``torch.matmul``.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from fresco_torch.ops.gemm import bmm


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call, CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rows(gen: torch.Generator, dev):
    """(name, a, x) of the TPU script's rows, operands N(0, 1) in bf16."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    f, hw, d = 8, 4096, 1280
    a, x = randn(f, hw, hw), randn(f, hw, d)
    v = randn(16, hw, 320)
    return [
        ("flat fij,fjd [8,4096,4096]x[8,4096,1280]", a, x),
        ("guidance fij,kfjc [2,8,4096,640]", a, x.reshape(f, hw, 2, d // 2).permute(2, 0, 1, 3).contiguous()),
        ("single [4096,4096]x[4096,1280]", a[:1], x[:1]),
        ("gram build [16,1024,320]x[16,320,4096]", v[:, :1024].contiguous(), v.transpose(1, 2).contiguous()),
    ]


def flops(a: torch.Tensor, x: torch.Tensor) -> float:
    return 2.0 * x.shape[:-2].numel() * a.shape[1] * a.shape[2] * x.shape[-1]


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"


def run(iters: int = 10, seed: int = 0) -> list[dict]:
    """Time every row with the kernel and ``torch.matmul``; returns one
    dict per (row, route)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for name, a, x in rows(gen, dev):
        fl = flops(a, x)
        ms = cuda_ms(lambda: bmm(a, x), iters)
        out.append(dict(row=name, route="bmm", ms=ms, tflops=fl / ms / 1e9))
        lib = cuda_ms(lambda: torch.matmul(a, x), iters)
        out.append(dict(row=name, route="torch.matmul bf16", ms=lib, tflops=fl / lib / 1e9))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm needs a CUDA device")
    print(card())
    for r in run(args.iters):
        print(f"{r['row']:44s} {r['route']:16s}: {r['ms']:8.3f} ms  {r['tflops']:6.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
