"""p2p.main_ms_per_step (ms/step): B3's cells launch inside the p2p
runner's step on the device clock (stamps "order" to "main"), averaged
over the untraced window steps (``portbench/stamps.py``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "main")
