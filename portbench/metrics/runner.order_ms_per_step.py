"""runner.order_ms_per_step (ms/step): the step's order stage on the
device clock (Morton key, sort, permutes: the stamps before and at
"order"), averaged over the untraced window steps."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "order")
