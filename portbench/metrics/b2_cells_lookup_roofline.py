"""b2_cells_lookup_roofline (%): B2's share of its roofline over the
traced steps: the least time of the steps' lookups (``roofline.py``:
bytes over 3.35 TB/s, from the lanes and distinct keys the reference
counts on the same states) over the device time of
``cells_window_lookup_kernel`` in those steps (torch.profiler)."""

from portbench import roofline, trace

KERNELS = ("cells_window_lookup_kernel",)


def read(ctx):
    sessions = [s for s in ctx.sessions if s.device and len(s.work) == s.steps]
    if not sessions:
        return None
    bound = sum(roofline.b2_bound_s(w) for s in sessions for w in s.work)
    return roofline.share_pct(bound, trace.kernel_us(sessions, KERNELS) / 1e6)
