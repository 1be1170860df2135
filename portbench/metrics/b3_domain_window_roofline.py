"""b3_domain_window_roofline (%): B3's cells entry point's share of its
roofline in the domain runner's steps: the least time of the traced
steps' window-pass work over the device time of ``p2p_window_kernel`` in
those steps, summed over every card (``trace.worked``), torch.profiler.
The work is each slab's buffer's, step by step (its own particles and
its ghosts, as the slab reference counts them: ``reference/domain.py``),
and its least time ``roofline_p2p.py``'s: bytes over 3.35 TB/s or
operations over 67 TFLOP/s, whichever is larger, on one card."""

from portbench import roofline, roofline_p2p, trace

KERNELS = ("p2p_window_kernel",)


def read(ctx):
    chunks = trace.worked(ctx.rank_sessions)
    if not chunks:
        return None
    bound = sum(roofline_p2p.b3_bound_s(w) for work, _ in chunks for w in work)
    every = [s for _, on_ranks in chunks for s in on_ranks]
    return roofline.share_pct(bound, trace.kernel_us(every, KERNELS) / 1e6)
