"""Host ms a frame in the port's ``engine.segment_head`` span
(``Engine.segment_head``: issuing preprocessing, backbone, argmax and
remap; beside ``engine_device_ms``, the device time it launches), over
the frames the engine took in the traced window (``engine_frames``).
Read in the traced window only: host ms under ``torch.profiler``, which
roughly doubles the host's cost of each op, so they are no match for the
device ms beside them nor for host times taken untraced."""


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:                 # a port without the span recorder
        return None
    frames = RECORDER.counters.get("engine_frames")
    if not ctx.trace or RECORDER.dropped or not frames:
        return None
    return RECORDER.total_ns("engine.segment_head") / 1e6 / frames
