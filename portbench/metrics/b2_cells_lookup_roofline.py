"""b2_cells_lookup_roofline (%): B2's share of its roofline over the
traced steps: the least time of the steps' lookups (``roofline.py``:
bytes over 3.35 TB/s, from the lanes and distinct keys the reference
counts on the same states) over the device time of
``cells_window_lookup_kernel`` in those steps, summed over every card
(``trace.worked``), torch.profiler."""

from portbench import roofline, trace

KERNELS = ("cells_window_lookup_kernel",)


def read(ctx):
    chunks = trace.worked(ctx.rank_sessions)
    if not chunks:
        return None
    bound = sum(roofline.b2_bound_s(w) for work, _ in chunks for w in work)
    every = [s for _, on_ranks in chunks for s in on_ranks]
    return roofline.share_pct(bound, trace.kernel_us(every, KERNELS) / 1e6)
