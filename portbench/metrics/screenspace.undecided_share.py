"""screenspace.undecided_share (%): the hybrid's screen-space stage
(``ops/screenspace.py::screen_space_collide``, hybrid) run once more on
the kept chunk-end states after the window: the real lanes it leaves
undecided (off screen, behind the camera, or occluded) over all real
lanes.  Those lanes take the exact stage."""


def probe(ctx):
    undecided = real = 0
    for out in ctx.kept_out.values():
        got = ctx.system.screen_space_stage(ctx.state_of(out))
        if got is None:
            return
        undecided += int(got[0].sum())
        real += int(got[1].sum())
    ctx.values["undecided"] = (undecided, real)


def read(ctx):
    u = ctx.values.get("undecided")
    if not u or not u[1]:
        return None
    return 100.0 * u[0] / u[1]
