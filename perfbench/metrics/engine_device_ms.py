"""Device ms per frame of the kernels launched inside the engine span
(``Engine.segment_head``: preprocessing, backbone, argmax and remap)."""

from perfbench.program import ENGINE_SPAN


def read(ctx, name):
    t = ctx.trace
    if not t or not t.frames or not t.span_device_s[ENGINE_SPAN]:
        return None
    return 1e3 * t.span_device_s[ENGINE_SPAN] / t.frames
