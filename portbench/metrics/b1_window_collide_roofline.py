"""b1_window_collide_roofline (%): B1's share of its roofline over the
traced steps: the least time of the steps' B1 work (``roofline.py``:
bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever is larger,
step by step, from the work the reference counts on the same states)
over the device time of every B1 kernel in those steps (the main and
phase-1 launches of ``window_collide_kernel`` with their split kernels,
and phase 2's worklist scan and collide kernels), torch.profiler."""

from portbench import roofline, trace

KERNELS = ("window_collide_kernel", "fill_keys_kernel", "finish_kernel",
           "worklist_scan_kernel", "worklist_collide_kernel")


def read(ctx):
    sessions = [s for s in ctx.sessions if s.device and len(s.work) == s.steps]
    if not sessions:
        return None
    bound = sum(roofline.b1_bound_s(w) for s in sessions for w in s.work)
    return roofline.share_pct(bound, trace.kernel_us(sessions, KERNELS) / 1e6)
