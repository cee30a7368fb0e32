"""Share of the device's busy time inside the feature optimization.

Device-busy time inside the device-side spans of the program's
``fresco::optimize_feature`` profiler range, over all device-busy time in
the traced window.
"""


def read(ctx):
    inside = ctx.trace.range_busy_s("fresco::optimize_feature")
    if inside is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * inside / ctx.trace.busy_s
