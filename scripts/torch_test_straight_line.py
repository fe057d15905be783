#!/usr/bin/env python3
"""Is the BEV matrix sane?  Straight lines must stay straight.

The port's counterpart of scripts/test_straight_line.py, with its flags
and report: a family of straight lines in camera space (lanes converging
to a vanishing point), three collinear points of each warped through the
calibrated homography; the largest distance of a middle point from the
line through its ends is reported (0 = straight; a homography maps lines
to lines).  Where cv2 is installed it also writes the side-by-side PNG
(camera | BEV) of the JAX package's script; without cv2 (the GPU host)
it reports only.

  python scripts/torch_test_straight_line.py --calib calib.json \\
      --out check.png
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--calib", required=True)
    p.add_argument("--out", default="straight_line_check.png")
    p.add_argument("--n-lines", type=int, default=7)
    return p.parse_args(argv)


def straightness(matrix: np.ndarray, in_w: int, in_h: int, n_lines: int):
    """(largest deviation in BEV pixels, the lanes' (bottom x, vanishing
    point) in camera pixels)."""
    from bugcar_image_segmentation_tpu_torch.geometry import \
        apply_homography

    vp = (in_w // 2, int(in_h * 0.35))
    worst, lanes = 0.0, []
    for i in range(n_lines):
        x_bot = int(in_w * i / (n_lines - 1))
        lanes.append((x_bot, vp))
        pts = np.array([[x_bot, in_h - 1],
                        [(x_bot + vp[0]) / 2, (in_h - 1 + vp[1]) / 2],
                        vp], dtype=np.float64)
        w = apply_homography(matrix, pts)
        a, b = w[2] - w[0], w[1] - w[0]
        d = abs(a[0] * b[1] - a[1] * b[0]) / max(np.linalg.norm(a), 1e-9)
        worst = max(worst, float(d))
    return worst, lanes


def render(path, matrix, in_w, in_h, out_w, out_h, lanes) -> bool:
    """The check image (camera | BEV) with cv2; False without cv2."""
    try:
        import cv2
    except ImportError:
        return False
    cam = np.zeros((in_h, in_w, 3), np.uint8)
    for x_bot, vp in lanes:
        cv2.line(cam, (x_bot, in_h - 1), vp, (0, 255, 0), 2)
    for j in range(1, 5):
        y = int(in_h * (0.45 + 0.13 * j))
        cv2.line(cam, (0, y), (in_w - 1, y), (255, 128, 0), 2)
    warped = cv2.warpPerspective(cam, matrix, (out_w, out_h))
    canvas = np.zeros((max(in_h, out_h), in_w + out_w, 3), np.uint8)
    canvas[:in_h, :in_w] = cam
    canvas[:out_h, in_w:] = warped
    cv2.putText(canvas, "camera", (8, 24), cv2.FONT_HERSHEY_SIMPLEX,
                0.7, (255, 255, 255), 1)
    cv2.putText(canvas, "BEV", (in_w + 8, 24), cv2.FONT_HERSHEY_SIMPLEX,
                0.7, (255, 255, 255), 1)
    cv2.imwrite(path, canvas)
    return True


def run(args) -> int:
    from bugcar_image_segmentation_tpu_torch.calibration import BEVTransform

    bev = BEVTransform.from_json(args.calib)
    in_w, in_h = bev.input_shape
    out_w, out_h = bev.output_shape
    worst, lanes = straightness(bev.matrix, in_w, in_h, args.n_lines)
    wrote = render(args.out, bev.matrix, in_w, in_h, out_w, out_h, lanes)
    where = f"wrote {args.out}" if wrote else "cv2 absent: no image written"
    print(f"{where}; max straightness deviation {worst:.3e} px "
          f"(0 = perfectly straight)")
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
