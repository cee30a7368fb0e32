"""Share of the traced window in which the card is idle while the host is
inside the denoise loop: the loop's launch-bound stall.

``prep_idle.keyframes``'s reading for the phase ``denoise_loop`` (the
host-side spans of ``fresco::denoise_loop`` cut to the window, less the
device-busy time inside them, over the window); it carries the profiler's
host cost as ``device_idle.keyframes`` does.  None where the trace has no
such range.
"""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_prep_idle_keyframes", os.path.join(os.path.dirname(__file__), "prep_idle.keyframes.py"))
_prep_idle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_prep_idle)


def read(ctx):
    return _prep_idle.idle_share(ctx.trace, ("denoise_loop",))
