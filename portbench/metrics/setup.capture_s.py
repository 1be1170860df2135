"""setup.capture_s (s): the runner's eager first step and its graph
captures, in the warm call, its set-up lap "capture" (``Stopwatch``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.setup_s(ctx, "capture")
