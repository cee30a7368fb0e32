"""Share of the traced window in which no operation ran on the card.

The profiler's host cost lengthens the window while the device's busy time
stays as it is, so this reads above an untraced run's idle share."""


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
