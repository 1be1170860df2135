"""rescue.device_ms_per_step (ms/step): rescue phases 1 and 2 on the
device clock (stamps "main" to "rescue": B1's phase-1 launch and the
worklist with their plans), averaged over the untraced window steps."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "rescue")
