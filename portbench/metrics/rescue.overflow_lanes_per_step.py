"""rescue.overflow_lanes_per_step (lanes/step): lanes whose candidates
did not fit the main launch's window, which the rescue redoes: the
runner's per-step counts (``with_stats=True``), averaged over the
window's steps."""


def read(ctx):
    if not ctx.overflow:
        return None
    return sum(ctx.overflow) / len(ctx.overflow)
