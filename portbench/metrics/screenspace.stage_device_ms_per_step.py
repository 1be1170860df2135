"""screenspace.stage_device_ms_per_step (ms/step): the hybrid's
screen-space stage inside the captured step, on the device clock
(stamps "start" to "screenspace"), averaged over the untraced window
steps; nothing for the spatial method."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "screenspace")
