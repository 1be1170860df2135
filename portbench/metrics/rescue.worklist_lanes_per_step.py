"""rescue.worklist_lanes_per_step (lanes/step): the lanes rescue phase 2
lists for B1's worklist entry point (``compact_lanes``' count, copied
on the device into the ring's "n_lanes" counter), averaged over every
step of the window."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    lanes = [r.counters["n_lanes"] for r in stamps.calls(ctx, untraced=False)]
    steps = sum(len(x) for x in lanes)
    return float(sum(x.sum() for x in lanes)) / steps if steps else None
