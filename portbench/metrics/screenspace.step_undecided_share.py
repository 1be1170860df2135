"""screenspace.step_undecided_share (%): the real lanes the hybrid's
screen-space stage left undecided, counted on the device in every step
of the window (the ring's "undecided" counter), over the real lanes of
those steps; nothing for the spatial method (-1 there)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    und = [r.counters["undecided"] for r in stamps.calls(ctx, untraced=False)]
    if not und or any((u < 0).any() for u in und):
        return None
    steps = sum(len(u) for u in und)
    return 100.0 * float(sum(u.sum() for u in und)) / (ctx.n_real * steps)
