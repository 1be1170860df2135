"""particle_steps_per_s (particle-steps/s): the real particles times every
step of the window's calls, over the window's wall seconds (the first
call's start to the last call's synchronize; host clock)."""

from portbench import roofline


def read(ctx):
    return roofline.rate(ctx.n_real, ctx.steps, ctx.seconds)
