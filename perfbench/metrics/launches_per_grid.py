"""CUDA kernels launched in the traced window per frame the engine was
handed (the pipeline's host dispatch: every launch costs host time)."""


def read(ctx, name):
    t = ctx.trace
    return t.kernel_launches / t.frames if t and t.frames else None
