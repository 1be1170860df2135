"""runner.host_reads_per_step (reads/step): device values the runner read
back to the host to decide a branch over the window (its own counter,
``runner.syncs.count``), over the window's steps."""


def read(ctx):
    return ctx.host_reads / ctx.steps if ctx.steps else None
