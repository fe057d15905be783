#!/usr/bin/env python3
"""Visual demo with the PyTorch port: synthetic road scene →
segmentation → occupancy grid.

The port's counterpart of scripts/demo.py, with its flags: the trained
demo checkpoint (read without msgpack or Flax) serves one synthetic road
frame through ``Pipeline``, and the side-by-side PNG (camera frame |
drivability map | BEV occupancy grid) is written where cv2 is installed;
the grid's cell counts are printed either way.

  python scripts/torch_demo.py \
      [--checkpoint checkpoints/enet_synthetic.msgpack] [--seed 4] \
      [--out demo.png] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint",
                   default="checkpoints/enet_synthetic.msgpack")
    p.add_argument("--seed", type=int, default=4)
    p.add_argument("--out", default="demo.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def render(path, frame, seg, grid) -> bool:
    """The demo image with cv2; False without cv2."""
    try:
        import cv2
    except ImportError:
        return False
    # drivability: green road / yellow flat / red obstacle
    seg_vis = np.zeros(seg.shape + (3,), np.uint8)
    seg_vis[seg == 1] = (80, 200, 80)
    seg_vis[seg == 0] = (60, 200, 230)
    seg_vis[seg == 2] = (60, 60, 220)
    # grid: unknown gray / free white / occupied black, upscaled
    g = np.full(grid.shape + (3,), 128, np.uint8)
    g[grid == 0] = 255
    g[grid == 100] = 0
    h = frame.shape[0]
    g = cv2.resize(g, (h, h), interpolation=cv2.INTER_NEAREST)
    canvas = np.zeros((h, frame.shape[1] + seg_vis.shape[1] + h + 20, 3),
                      np.uint8)
    canvas[:, :frame.shape[1]] = frame
    x = frame.shape[1] + 10
    canvas[:, x:x + seg_vis.shape[1]] = seg_vis
    x += seg_vis.shape[1] + 10
    canvas[:, x:x + h] = g
    cv2.imwrite(path, canvas)
    return True


def run(args):
    """(grid, drivability map) of the demo frame, as numpy."""
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.configs import GridConfig
    from bugcar_image_segmentation_tpu_torch.models.api import build_engine
    from bugcar_image_segmentation_tpu_torch.pipeline import Pipeline
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables

    variables, cfg = load_variables(args.checkpoint)
    engine = build_engine("enet", cfg, variables=variables,
                          device=args.device)
    cal = toy_calibration((cfg.input_height, cfg.input_width))
    pipe = Pipeline(engine, cal, GridConfig(8.0, 8.0, 0.1))
    frame, _ = synthetic.road_scene(np.random.default_rng(args.seed),
                                    (cfg.input_height, cfg.input_width))
    grid, seg = pipe.segment_and_grid(frame)
    grid, seg = grid.cpu().numpy(), seg.cpu().numpy()
    wrote = render(args.out, frame, seg, grid)
    occ = {int(v): int((grid == v).sum()) for v in np.unique(grid)}
    where = f"wrote {args.out}" if wrote else "cv2 absent: no image written"
    print(f"{where}; grid cells {occ}")
    return grid, seg


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
