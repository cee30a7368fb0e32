"""Mean device time of one launch of the flash-attention kernel, in us.

The profiler's device time of the kernels named ``flash_fwd*`` in the
traced window over the launches that the program's ``flash_attention``
wrapper counted in the window.
"""


def read(ctx):
    launches = (ctx.stats.get("launches") or {}).get("flash_attn_fwd", 0)
    seconds, _ = ctx.trace.kernel_seconds("flash_fwd")
    if launches <= 0 or seconds <= 0:
        return None
    return 1e6 * seconds / launches
