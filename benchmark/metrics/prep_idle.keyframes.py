"""Share of the traced window in which the card is idle while the host is
inside a prep phase.

The host-side spans of the program's phase ranges ``fresco::<phase>`` for
the prep phases of ``prep_share.keyframes`` (``PREP``), their union cut to
the window, less the device-busy time inside it, over the window.  The
phases do not overlap the denoise loop's, so this and
``denoise_idle.keyframes`` are parts of ``device_idle.keyframes``; like it,
both carry the profiler's host cost, which lengthens the host's spans while
the device's work stays as it is.  None where the trace has no such range.
"""
import numpy as np

from benchmark.harness.trace import overlap, union

# the prep phases of ``prep_share.keyframes``
PREP = ("interframe_prep", "control_detector", "saliency", "intraframe_prep", "encode_prompts", "attn_params")


def idle_share(trace, phases) -> float | None:
    """Idle share of the window while the host is inside any of ``phases``' ranges."""
    spans = [trace.host_ranges[f"fresco::{p}"] for p in phases if f"fresco::{p}" in trace.host_ranges]
    lo, hi = trace.window_ns
    if not spans or hi <= lo:
        return None
    inside = union(np.clip(np.concatenate([s for s, _ in spans]), lo, hi),
                   np.clip(np.concatenate([e for _, e in spans]), lo, hi))
    held = float(np.sum(inside[1] - inside[0]))
    return 100.0 * (held - overlap(inside, trace.busy)) / (hi - lo)


def read(ctx):
    return idle_share(ctx.trace, PREP)
