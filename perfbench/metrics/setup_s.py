"""Seconds from the process start to the first timed frame: loading,
building (the kernels are built once a checkout, then loaded), weights
and frames from the seed, and the warm-up of the cell's shapes."""


def read(ctx, name):
    return ctx.setup_s
