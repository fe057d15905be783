"""Share of the traced window in which no operation ran on the device,
in %: 100 minus the union of the device intervals over the window."""


def read(ctx, name):
    t = ctx.trace
    if not t or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
