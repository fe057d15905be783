"""Share of the frames the port's engine took in the traced window that a
replay of its CUDA graph served: 100 x ``engine_graph_frames`` over
``engine_frames`` (``Engine.segment_head``).  Absent from a port whose
engine replays no graph, which counts no ``engine_graph_frames``."""


def read(ctx, name):
    try:
        from bugcar_image_segmentation_tpu_torch.models.api import \
            replays  # noqa: F401  (a port that replays graphs)
        from bugcar_image_segmentation_tpu_torch.utils.profiling import \
            RECORDER
    except ImportError:
        return None
    frames = RECORDER.counters.get("engine_frames")
    if not ctx.trace or RECORDER.dropped or not frames:
        return None
    return 100.0 * RECORDER.counters.get("engine_graph_frames", 0) / frames
