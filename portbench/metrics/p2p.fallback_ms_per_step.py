"""p2p.fallback_ms_per_step (ms/step): the p2p runner's window-overflow
fallback on the device clock (the compaction and B3's worklist launch:
stamps "main" to "rescue"), averaged over the untraced window steps
(``portbench/stamps.py``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "rescue")
