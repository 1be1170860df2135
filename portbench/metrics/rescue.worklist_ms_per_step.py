"""rescue.worklist_ms_per_step (ms/step): device time of rescue phase 2,
B1's worklist entry point (its scan and collide kernels), over the
traced steps, each card's mean (torch.profiler)."""

from portbench import trace

KERNELS = ("worklist_scan_kernel", "worklist_collide_kernel")


def read(ctx):
    sessions = trace.traced(ctx.rank_sessions)
    if not sessions:
        return None
    return trace.kernel_us(sessions, KERNELS) / 1e3 / sum(s.steps for s in sessions)
