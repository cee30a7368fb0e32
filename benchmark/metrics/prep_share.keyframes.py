"""Share of the window's wall in the keyframe stage's prep phases.

The phases of ``FrescoPipeline.phases`` that prepare a batch (flows and
occlusion, the control detector, saliency, the intra-frame pass, prompt
encoding, the attention parameters), summed over the window's batches,
over the window's wall.  The traced run, and only it, sets
``sync_phases``, so each phase holds the device work it queued; both the
phases and the wall carry the profiler's host cost.
"""
PREP = ("interframe_prep", "control_detector", "saliency", "intraframe_prep", "encode_prompts", "attn_params")


def read(ctx):
    phases = ctx.stats.get("phases") or {}
    if not any(p in phases for p in PREP):
        return None
    return 100.0 * sum(phases.get(p, 0.0) for p in PREP) / ctx.stats["wall_s"]
