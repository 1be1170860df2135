"""b3_p2p_window_roofline (%): B3's cells entry point's share of its
roofline over the traced steps: the least time of the steps' window-pass
work (``roofline_p2p.py``: bytes over 3.35 TB/s or operations over
67 TFLOP/s, whichever is larger, step by step, from the work the
reference counts on the same states) over the device time of
``p2p_window_kernel`` in those steps (torch.profiler).  The worklist
kernel that redoes the overflow lanes is not in it."""

from portbench import roofline, roofline_p2p, trace

KERNELS = ("p2p_window_kernel",)


def read(ctx):
    sessions = [s for s in ctx.sessions if s.device and len(s.work) == s.steps]
    if not sessions:
        return None
    bound = sum(roofline_p2p.b3_bound_s(w) for s in sessions for w in s.work)
    return roofline.share_pct(bound, trace.kernel_us(sessions, KERNELS) / 1e6)
