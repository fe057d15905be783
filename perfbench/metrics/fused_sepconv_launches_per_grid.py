"""Launches of the separable-conv kernel per grid in the traced window:
the port's counter ``launches.fused_sepconv`` (every launch, those a CUDA
graph's replay makes included) over the grids the drains delivered
(``grids_out``).  One launch takes a whole engine call's batch, so it
reads the kernel's sites over the frames a call takes.  Absent from a
port that keeps no such counter."""


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:                 # a port without the span recorder
        return None
    launches = RECORDER.counters.get("launches.fused_sepconv")
    grids = RECORDER.counters.get("grids_out")
    if not ctx.trace or RECORDER.dropped or not launches or not grids:
        return None
    return launches / grids
