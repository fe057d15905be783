#!/usr/bin/env python3
"""Streaming inference with the PyTorch port: camera/video → occupancy
grids (→ ROS where rospy is installed).

The port's counterpart of scripts/inference_video.py, with its flags and
loop: capture thread → native frame ring (``io``) → the frame→grid
pipeline on the card → ROS-free message (``msg.GridPublisher``).  Offline
sources (``--video``, ``--synthetic``) process every frame in order through
``Pipeline.stream(depth=16, sync_chunk=16)`` with producer backpressure;
a live ``--camera`` takes the freshest frame (older ones count as dropped).

  python scripts/torch_inference_video.py --calib calib.json [--camera 0 |
      --video clip.mp4 | --synthetic N] [--model enet] [--clahe]
      [--contour-filter] [--display] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given.  ``--camera``,
``--video`` and ``--display`` need cv2; ``--synthetic`` needs none.
"""

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

MODELS = ("enet", "deeplab", "unet", "segformer")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--camera", type=int)
    src.add_argument("--video", type=str)
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="N generated frames (benchmark/smoke mode)")
    p.add_argument("--calib", required=True)
    p.add_argument("--model", default="enet", choices=MODELS)
    p.add_argument("--checkpoint", help="msgpack variables (Flax layout)")
    p.add_argument("--grid", default="8x8x0.1",
                   help="WIDTHxHEIGHTxCELL in meters")
    p.add_argument("--clahe", action="store_true",
                   help="CLAHE pre-enhancement")
    p.add_argument("--contour-filter", action="store_true",
                   help="footwell-connectivity road filtering")
    p.add_argument("--display", action="store_true")
    p.add_argument("--no-host-resize", action="store_true",
                   help="resize on the device instead of before the copy")
    p.add_argument("--temporal-fusion", action="store_true",
                   help="log-odds evidence accumulation across frames")
    p.add_argument("--fusion-decay", type=float, default=0.9)
    p.add_argument("--fusion-occupied-threshold", type=float, default=1.5)
    p.add_argument("--fusion-free-threshold", type=float, default=0.25)
    p.add_argument("--topic", default="/occupancy_grid")
    p.add_argument("--frame-id", default="base_link")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def run(args: argparse.Namespace,
        on_grid: Optional[Callable[[np.ndarray], None]] = None) -> dict:
    """The loop; ``on_grid`` sees each published grid.  Returns frames,
    dropped, seconds and fps."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.calibration import BEVTransform
    from bugcar_image_segmentation_tpu_torch.fusion import TemporalGridFusion
    from bugcar_image_segmentation_tpu_torch.io import (DropCounter,
                                                        OpenCVSource,
                                                        StallWatchdog,
                                                        SyntheticSource,
                                                        ThreadedCapture)
    from bugcar_image_segmentation_tpu_torch.msg import (
        GridPublisher, to_occupancy_grid_msg)
    from bugcar_image_segmentation_tpu_torch.utils import (FPSMeter,
                                                           get_logger)
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables

    log = get_logger("inference_video")
    gw, gh, cell = (float(v) for v in args.grid.split("x"))

    variables = None
    if args.checkpoint:
        variables, _ = load_variables(args.checkpoint)
    engine = port.build_engine(args.model, variables=variables,
                               device=args.device)
    bev = BEVTransform.from_json(args.calib)
    pipe = port.Pipeline(engine, bev.config, port.GridConfig(gw, gh, cell),
                         use_clahe=args.clahe,
                         contour_filter=args.contour_filter,
                         host_resize=not args.no_host_resize)
    log.info("warm-up frame in %.1fs", pipe.warmup((480, 640, 3)))

    if args.synthetic is not None:
        source = SyntheticSource((480, 640, 3), num_frames=args.synthetic)
    elif args.video is not None:
        source = OpenCVSource(args.video)
    else:
        source = OpenCVSource(args.camera)

    publisher = GridPublisher(args.topic)
    meter = FPSMeter()
    drops = DropCounter()
    watchdog = StallWatchdog(stall_after_s=2.0).start()
    live = args.camera is not None
    frame0 = next(iter(source))
    cap = ThreadedCapture(source, frame0.shape,
                          block_when_full=not live).start()
    cap.ring.push(frame0)

    frames = 0
    t_start = time.time()
    # numpy fusion: the grids are host arrays here already
    fusion = (TemporalGridFusion(
        (int(gh / cell), int(gw / cell)), decay=args.fusion_decay,
        occupied_threshold=args.fusion_occupied_threshold,
        free_threshold=args.fusion_free_threshold, backend="numpy")
        if args.temporal_fusion else None)

    def handle(grid: np.ndarray) -> bool:
        nonlocal frames
        if fusion is not None:
            grid = fusion.update(grid)
        publisher.publish(to_occupancy_grid_msg(
            grid, cell, gw, gh, time_stamp=time.time(),
            frame_id=args.frame_id))
        if on_grid is not None:
            on_grid(grid)
        meter.tick()
        frames += 1
        if frames % 60 == 0:
            log.info("%d frames, %.1f fps, %d dropped",
                     frames, meter.fps, drops.dropped)
        if args.display:
            import cv2
            vis = ((grid.astype(np.int16) + 1) * 2).astype(np.uint8)
            cv2.imshow("occupancy", vis)
            return (cv2.waitKey(1) & 0xFF) != ord("q")
        return True

    if live:
        # latency first: the freshest frame, its grid fetched each frame
        while True:
            item = cap.latest(timeout_ms=500)
            if item is None:
                break
            frame, dropped = item
            drops.record(dropped)
            watchdog.tick()
            if not handle(pipe(frame).cpu().numpy()):
                break
    else:
        # throughput first: every frame, in order, results fetched in chunks
        def frame_gen():
            while True:
                item = cap.next(timeout_ms=500)
                if item is None:
                    return
                watchdog.tick()
                yield item[0]

        for grid in pipe.stream(frame_gen(), depth=16, sync_chunk=16):
            if not handle(grid):
                break
    cap.stop()
    watchdog.stop()
    dt = time.time() - t_start
    log.info("done: %d frames in %.1fs (%.1f fps), %d dropped",
             frames, dt, frames / max(dt, 1e-9), drops.dropped)
    return {"frames": frames, "dropped": drops.dropped, "seconds": dt,
            "fps": frames / max(dt, 1e-9)}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
