"""Mean of the port's ``device_backlog`` gauge over the traced window: at
each dispatch of ``Pipeline.stream``, the earlier dispatches the card had
not finished (CUDA events).  Near 0 the device starves and the host sets
the pace; near the stream's depth the device does.  Read in the traced
window only, where ``torch.profiler`` slows the host's issue of each op
and so can shorten the backlog the untraced stream keeps."""


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:                 # a port without the span recorder
        return None
    if not ctx.trace or RECORDER.dropped:
        return None
    return RECORDER.gauge_mean("device_backlog")
