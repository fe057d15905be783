"""The model's FLOPs per grid (``costs/model.py``) times the grids
completed per second, over the bf16 peak, in %: taken over the traced
run's untraced window, before the profiler starts."""

from perfbench import manifest, peaks


def read(ctx, name):
    w = ctx.window
    if not w.get("grids"):
        return None
    flops = manifest.cost("model", ctx.base).flops_per_grid(ctx.cfg)
    return 100.0 * flops * w["grids"] / w["seconds"] / peaks.BF16_FLOP_S
