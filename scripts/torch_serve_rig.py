#!/usr/bin/env python3
"""Multi-camera rig serving with the PyTorch port: N cameras → one
stitched occupancy grid.

The port's counterpart of scripts/serve_rig.py, with its flags: each
camera has its own calibration into the shared vehicle grid, the frames
run the backbone as one batch, the per-camera grids max-merge on the card
(``MultiCameraPipeline``, BASELINE config 4), and the stitched grid
publishes as one nav_msgs/OccupancyGrid (``msg.GridPublisher``).

  python scripts/torch_serve_rig.py --calibs front.json left.json \\
      right.json [--cameras 0 1 2 | --synthetic N] [--model enet_w16]
      [--checkpoint ck] [--temporal-fusion] [--grid 8x8x0.1]
      [--device cuda|cpu]

Offline (``--synthetic``) runs every tick in lockstep; live cameras take
the freshest frame from each ring (older frames drop, counted).  Camera
frames are resized to the model's resolution on the host
(``ops/host_resize.resize_linear``, cv2's bytes without cv2); only
``--cameras`` needs cv2.
"""

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--calibs", nargs="+", required=True,
                   help="one calibration JSON per camera, same order as "
                        "--cameras")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--cameras", type=int, nargs="+",
                     help="cv2 device indices, one per calibration")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="N synthetic ticks (smoke/benchmark mode)")
    p.add_argument("--model", default="enet_w16")
    p.add_argument("--checkpoint")
    p.add_argument("--grid", default="8x8x0.1",
                   help="WIDTHxHEIGHTxCELL in meters")
    p.add_argument("--interpolation", default="cv2_linear",
                   choices=["cv2_linear", "nearest", "native"])
    p.add_argument("--temporal-fusion", action="store_true")
    p.add_argument("--fusion-decay", type=float, default=0.9)
    p.add_argument("--topic", default="/occupancy_grid")
    p.add_argument("--frame-id", default="base_link")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.cameras and len(args.cameras) != len(args.calibs):
        p.error(f"{len(args.cameras)} cameras vs {len(args.calibs)} "
                f"calibrations")
    return args


def run(args: argparse.Namespace,
        on_grid: Optional[Callable[[np.ndarray], None]] = None) -> dict:
    """The rig loop; ``on_grid`` sees each stitched grid.  Returns ticks,
    cameras, dropped frames, seconds and ticks a second."""
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
    from bugcar_image_segmentation_tpu_torch.ops.host_resize import \
        resize_linear
    from bugcar_image_segmentation_tpu_torch.utils import (FPSMeter,
                                                           get_logger)
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables

    log = get_logger("serve_rig")
    gw, gh, cell = (float(v) for v in args.grid.split("x"))

    variables, ckpt_cfg = None, None
    if args.checkpoint:
        variables, ckpt_cfg = load_variables(args.checkpoint)
    engine = port.build_engine(args.model, cfg=ckpt_cfg, variables=variables,
                               device=args.device)
    cals = [BEVTransform.from_json(c).config for c in args.calibs]
    rig = port.MultiCameraPipeline(engine, cals,
                                   port.GridConfig(gw, gh, cell),
                                   interpolation=args.interpolation)
    n_cam = len(cals)
    mh, mw = engine.cfg.input_height, engine.cfg.input_width

    def prep(frames) -> np.ndarray:
        """The camera frames at the model's resolution, one array."""
        return np.stack([f if f.shape[:2] == (mh, mw)
                         else resize_linear(f, (mh, mw)) for f in frames])

    publisher = GridPublisher(args.topic)
    meter = FPSMeter()
    drops = DropCounter()
    watchdog = StallWatchdog(stall_after_s=2.0).start()
    fusion = (TemporalGridFusion((int(gh / cell), int(gw / cell)),
                                 decay=args.fusion_decay, backend="numpy")
              if args.temporal_fusion else None)

    ticks = 0
    t_start = time.time()

    def handle(grid: np.ndarray) -> None:
        nonlocal ticks
        if fusion is not None:
            grid = fusion.update(grid)
        publisher.publish(to_occupancy_grid_msg(
            grid, cell, gw, gh, time_stamp=time.time(),
            frame_id=args.frame_id))
        if on_grid is not None:
            on_grid(grid)
        meter.tick()
        ticks += 1
        if ticks % 60 == 0:
            log.info("%d rig ticks, %.1f ticks/s, %d dropped frames",
                     ticks, meter.fps, drops.dropped)

    t0 = time.time()
    rig(np.zeros((n_cam, mh, mw, 3), np.uint8)).cpu()
    log.info("warm-up %d-camera tick in %.1fs", n_cam, time.time() - t0)

    if args.synthetic is not None:
        # at model resolution: no host resize in the measured ticks
        iters = [iter(SyntheticSource((mh, mw, 3), num_frames=args.synthetic,
                                      seed=k)) for k in range(n_cam)]
        try:
            while True:
                frames = [next(it) for it in iters]
                watchdog.tick()
                handle(rig(prep(frames)).cpu().numpy())
        except StopIteration:
            pass
    else:
        caps = []
        for cam in args.cameras:
            source = OpenCVSource(cam)
            f0 = next(iter(source))
            cap = ThreadedCapture(source, f0.shape,
                                  block_when_full=False).start()
            cap.ring.push(f0)
            caps.append(cap)
        try:
            while True:
                frames = []
                for cap in caps:
                    item = cap.latest(timeout_ms=500)
                    if item is None:
                        raise StopIteration
                    frames.append(item[0])
                    drops.record(item[1])
                watchdog.tick()
                handle(rig(prep(frames)).cpu().numpy())
        except (StopIteration, KeyboardInterrupt):
            pass
        finally:
            for cap in caps:
                cap.stop()
    watchdog.stop()
    dt = time.time() - t_start
    log.info("done: %d rig ticks in %.1fs (%.1f ticks/s, %d cameras), "
             "%d dropped frames", ticks, dt, ticks / max(dt, 1e-9),
             n_cam, drops.dropped)
    return {"ticks": ticks, "cameras": n_cam, "dropped": drops.dropped,
            "seconds": dt, "ticks_per_s": ticks / max(dt, 1e-9)}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
