"""Share of the device's busy time inside the gram.

Device-busy time inside the device-side spans of the program's
``fresco::gram`` range, over all device-busy time in the traced window.
The range holds every call of the gram's gradient (``_gram_l1_grad``,
whichever path it takes: the dense sign-gram kernels or the factored
float32 products) and each call's one dense build of the reference gram,
so a move between the paths shows here.  None where the trace has no such
range (a program without it).
"""


def read(ctx):
    inside = ctx.trace.range_busy_s("fresco::gram")
    if inside is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * inside / ctx.trace.busy_s
