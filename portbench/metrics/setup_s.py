"""setup_s (s): process start to the window's start: imports, inputs,
the program's tables and bake, the warm call with its captures (host
clock)."""


def read(ctx):
    return ctx.setup_s
