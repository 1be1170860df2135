"""p2p.step_ms_p99 (ms): the 99th percentile of the p2p runner's step
period on the device clock, one step's "start" stamp to the next's
within a call (the idle between replays included), over the untraced
window calls (``portbench/stamps.py``)."""

import numpy as np

from portbench import stamps

probe = stamps.take


def read(ctx):
    p = [r.period_ms for r in stamps.calls(ctx)]
    p = np.concatenate(p) if p else np.zeros(0)
    return float(np.percentile(p, 99)) if p.size else None
