"""Products of operands that hold bfloat16 values, on TF32 tensor cores.

TF32 keeps 10 mantissa bits, so an operand whose values are bfloat16 (7
bits) enters a TF32 product exactly, and the products accumulate in
float32: for such operands TF32 gives float32's result, summed in another
order, at tensor-core speed.  Everywhere else the reference computes in
float32 with TF32 off.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_for_bf16_operands(enabled: bool = True):
    """TF32 matrix products inside the block (``enabled``: the operands hold bf16 values)."""
    if not enabled:
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
