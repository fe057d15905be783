"""95th percentile of every frame's latency in the window, from
taking the frame to its int8 grid on the host, in ms (live loops)."""

from perfbench.stats import percentile


def read(ctx, name):
    lat = ctx.window.get("latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None
