"""Host ms a frame in the port's ``pipeline.upload`` span
(``Pipeline._upload``: the host's preparation of the frames, their stack
and the pageable host→device copy), over the frames the engine took in the
traced window (the port's ``engine_frames`` counter).
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
    return RECORDER.total_ns("pipeline.upload") / 1e6 / frames
