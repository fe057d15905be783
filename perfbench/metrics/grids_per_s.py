"""Every grid delivered to the host in the window over all the window's
seconds."""


def read(ctx, name):
    return ctx.window["grids"] / ctx.window["seconds"]
