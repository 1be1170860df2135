"""runner.replay_gap_ms_per_step (ms/step): the device's idle between one
step and the next within a call, on the device clock: a step's "end"
stamp to the next step's "start" (``psys_stamp_kernel``: the host's flag
read and graph launch, where the device waits on them), averaged over
those gaps of the untraced window calls (``portbench/stamps.py``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    gaps = [r.gap_ms for r in stamps.calls(ctx)]
    n = sum(len(g) for g in gaps)
    return float(sum(g.sum() for g in gaps)) / n if n else None
