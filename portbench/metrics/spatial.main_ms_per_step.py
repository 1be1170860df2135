"""spatial.main_ms_per_step (ms/step): the plan, B2 and B1's main launch
on the device clock (stamps "order" to "main"), averaged over the
untraced window steps."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "main")
