"""Host ms a grid in the port's ``pipeline.drain`` span (``Pipeline.stream``
fetching a chunk of dispatches to the host: the wait for the device and
the device→host copy), over the grids the drains delivered in the traced
window (the port's ``grids_out`` counter).
Read in the traced window only: host ms under ``torch.profiler``, which
roughly doubles the host's cost of each op, so they are no match for the
device ms beside them nor for host times taken untraced."""


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:                 # a port without the span recorder
        return None
    grids = RECORDER.counters.get("grids_out")
    if not ctx.trace or RECORDER.dropped or not grids:
        return None
    return RECORDER.total_ns("pipeline.drain") / 1e6 / grids
