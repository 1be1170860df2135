"""device.idle_share (%): the share of the traced chunks' span in which
no record (kernel, copy, set) ran on the card: 1 - the union of the
device records over the span from each chunk's first record to its last
(torch.profiler), over every card's traced chunks: the line's
``busy_s`` / ``window_s``."""

from portbench import roofline, trace


def read(ctx):
    bw = [trace.busy_window_us(s) for s in trace.traced(ctx.rank_sessions)]
    if not bw:
        return None
    return roofline.idle_pct(sum(b for b, _ in bw), sum(w for _, w in bw))
