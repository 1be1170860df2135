"""screenspace.stage_ms (ms): the hybrid's screen-space stage
(``screen_space_collide``, hybrid) on the last kept chunk-end state,
timed from outside by CUDA events after the window: the median of 20
calls after one warm call."""

import statistics

import torch

CALLS = 20


def probe(ctx):
    if ctx.device.type != "cuda" or not ctx.kept_out:
        return
    st = ctx.state_of(ctx.kept_out[max(ctx.kept_out)])
    if ctx.system.screen_space_stage(st) is None:
        return
    times = []
    for _ in range(CALLS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ctx.system.screen_space_stage(st)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ctx.values["stage_ms"] = statistics.median(times)


def read(ctx):
    return ctx.values.get("stage_ms")
