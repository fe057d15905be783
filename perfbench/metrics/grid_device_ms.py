"""Device ms per frame of the kernels launched inside the grid span
(``OccupancyGridBuilder.build``: BEV warp, opening, binning)."""

from perfbench.program import GRID_SPAN


def read(ctx, name):
    t = ctx.trace
    if not t or not t.frames or not t.span_device_s[GRID_SPAN]:
        return None
    return 1e3 * t.span_device_s[GRID_SPAN] / t.frames
