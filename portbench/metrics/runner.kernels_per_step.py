"""runner.kernels_per_step (kernels/step): kernel records on the card in
the traced chunks over the steps they hold, on every card (each card's
mean; torch.profiler; copies and sets left out).  The profiler has lost a whole step's records before, so
B2's launches (one a step) are counted against the steps run."""

from portbench import trace

B2 = "cells_window_lookup_kernel"


def read(ctx):
    sessions = trace.traced(ctx.rank_sessions)
    if not sessions:
        return None
    steps = sum(s.steps for s in sessions)
    b2 = trace.kernel_count(sessions, B2)
    if b2 != steps:
        ctx.log(f"[portbench] runner.kernels_per_step: the trace holds {b2} "
                f"launches of {B2} over {steps} steps run")
    kernels = sum(1 for s in sessions for n, _, _ in s.device if trace.is_kernel(n))
    return kernels / steps
