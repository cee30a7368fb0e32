"""The denoise loop's model FLOPs as a share of the card's bf16 peak
(989 TFLOP/s, H100 SXM, dense) over the traced window's device-busy time.

The FLOPs are counted from the configuration's published shapes
(``harness/flops.py``): the UNet and ControlNet passes of every denoising
step after warm-up of every batch finished in the window (CFG's doubled
batch included), plus each batch's VAE encode and decode.  FRESCO's own
extra work is not counted.  The time is the card's busy time, not the
window's wall: the profiler lengthens the wall by its host cost, while the
busy time of a call is the same traced or not; the window's idle share is
``device_idle.keyframes``.  The card's power limit is printed beside it.
"""
PEAK_FLOPS = 989e12


def read(ctx):
    flops = ctx.stats.get("model_flops")
    if not flops or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * flops / (ctx.trace.busy_s * PEAK_FLOPS)
