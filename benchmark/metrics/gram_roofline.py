"""The gram's least time as a share of its device-busy time.

Work: each call of the gram's gradient that the program counted in the
window (``fresco_torch.kernels.work_counts()["gram"]``, by v's (B, hw, c),
the batch included) needs the symmetric gram G = v·vᵀ, half of it
B·hw²·c multiply-adds, and S·v, B·hw²·c more: 3·B·hw²·c FLOPs, the least
work of any path (the dense kernels compute all of G, the factored path
all of G and C's rows again).  At the bf16 tensor peak (989 TFLOP/s, H100
SXM, dense) that is the least time; the share is it over the device-busy
time inside the ``fresco::gram`` range, which also holds the one dense
build of the reference gram a call, counted as no work.  Counting less
work than any path does keeps the share at or below 100 %: a reading over
it means the count or the range is wrong.  The factored path runs float32
CUDA-core products, so it reads a few % against this peak.  None where the
range or the counter is absent (a program without them).
"""
PEAK_FLOPS = 989e12


def read(ctx):
    from fresco_torch import kernels

    inside = ctx.trace.range_busy_s("fresco::gram")
    work_counts = getattr(kernels, "work_counts", None)
    counts = work_counts()["gram"] if work_counts else None
    if not inside or not counts:
        return None
    flops = sum(3 * b * hw * hw * c * n for (b, hw, c), n in counts.items())
    return 100.0 * flops / PEAK_FLOPS / inside
