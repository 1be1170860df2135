"""p2p.overflow_lanes_per_step (lanes/step): particles with a run outside
its window, which the p2p runner's fallback redoes: the runner's
per-step counts (``with_stats=True``, its ring's "n_over" counter),
averaged over the window's steps."""


def read(ctx):
    if not ctx.overflow:
        return None
    return sum(ctx.overflow) / len(ctx.overflow)
