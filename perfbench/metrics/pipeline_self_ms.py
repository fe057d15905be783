"""The pipeline's own host ms a frame: the self time (duration less what
the child spans cover) of the port's ``pipeline.frame``,
``pipeline.dispatch`` and ``pipeline.program`` spans, over the frames the
engine took in the traced window (``engine_frames``).  With the upload,
engine and grid host ms it sums to the host time inside the pipeline.
Read in the traced window only: host ms under ``torch.profiler``, which
roughly doubles the host's cost of each op, so they are no match for the
device ms beside them nor for host times taken untraced."""

SPANS = ("pipeline.frame", "pipeline.dispatch", "pipeline.program")


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:                 # a port without the span recorder
        return None
    frames = RECORDER.counters.get("engine_frames")
    if not ctx.trace or RECORDER.dropped or not frames:
        return None
    return sum(RECORDER.self_ns(s) for s in SPANS) / 1e6 / frames
