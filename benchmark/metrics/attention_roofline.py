"""Attention's least time as a share of its device-busy time.

Work: each call of ``flash_attention`` that the program counted in the
window (``fresco_torch.kernels.work_counts()["attention"]``, by (B, H, Sq,
Sk, D), Sk the keys given) needs the products q·kᵀ and p·v, 4·B·H·Sq·Sk·D
FLOPs, and reads q, k and v and writes the output once, all bf16:
2·(2·B·H·Sq·D + 2·B·H·Sk·D) bytes.  A call's least time is the larger of
the FLOPs at the bf16 tensor peak (989 TFLOP/s, H100 SXM, dense) and the
bytes at 3.35 TB/s; the share is the calls' least times summed, over the
device-busy time inside the ``fresco::attention`` range.  The softmax's
exp2 is left out of the bound on purpose, and so is the key mask (B·Sk
bytes, under 1/(4·H·D) of k's and v's; the count does not say which calls
had one): a bound of tensor FLOPs and bytes alone cannot be beaten, so the
share stays at or below 100 %, with one caveat: the kernel skips key tiles
with no valid key, and the cross-frame attention's compacted keys end in
up to max(hw/2, 128) masked ones, which are counted here as work.  The
77-key text cross-attention and the trajectory attention do not go
through ``flash_attention`` and are in neither the count nor the range.
None where the range or the counter is absent (a program without them).
"""
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def read(ctx):
    from fresco_torch import kernels

    inside = ctx.trace.range_busy_s("fresco::attention")
    work_counts = getattr(kernels, "work_counts", None)
    counts = work_counts()["attention"] if work_counts else None
    if not inside or not counts:
        return None
    least = sum(n * max(4 * b * h * sq * sk * d / PEAK_FLOPS, 4 * b * h * d * (sq + sk) / PEAK_BYTES)
                for (b, h, sq, sk, d), n in counts.items())
    return 100.0 * least / inside
