"""Median of every frame's latency in the window, in ms (live loops)."""

from perfbench.stats import percentile


def read(ctx, name):
    lat = ctx.window.get("latencies_s")
    return percentile(lat, 50) * 1e3 if lat else None
