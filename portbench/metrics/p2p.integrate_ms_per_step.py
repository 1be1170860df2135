"""p2p.integrate_ms_per_step (ms/step): the end of the p2p runner's step
on the device clock (the walls, the integrator and the write-back into
the carried rows: stamps "rescue" to "end"), averaged over the untraced
window steps (``portbench/stamps.py``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "end")
