"""b1_window_collide_roofline (%): B1's share of its roofline over the
traced steps: the least time of the steps' B1 work (``roofline.py``:
bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever is larger,
step by step, from the work the reference counts on the same states)
over the device time of every B1 kernel in those steps (the main and
phase-1 launches of ``window_collide_kernel`` with their split kernels,
and phase 2's worklist scan and collide kernels), summed over every
card (``trace.worked``), torch.profiler."""

from portbench import roofline, trace

KERNELS = ("window_collide_kernel", "fill_keys_kernel", "finish_kernel",
           "worklist_scan_kernel", "worklist_collide_kernel")


def read(ctx):
    chunks = trace.worked(ctx.rank_sessions)
    if not chunks:
        return None
    bound = sum(roofline.b1_bound_s(w) for work, _ in chunks for w in work)
    every = [s for _, on_ranks in chunks for s in on_ranks]
    return roofline.share_pct(bound, trace.kernel_us(every, KERNELS) / 1e6)
