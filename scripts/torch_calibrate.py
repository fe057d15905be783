#!/usr/bin/env python3
"""Camera → BEV calibration with the PyTorch port.

The port's counterpart of scripts/calibrate.py, with its flags and JSON
(the reference's schema): headless from four fiducial corners or from
four tile edge lines, numpy only; or interactive from a camera, which
needs cv2.

  # headless: corners given on the command line
  python scripts/torch_calibrate.py --corners 210,170 305,168 330,235 \\
      185,242 --input-size 512x256 --output-size 512x512 \\
      --dist2target 5,110 --tile-length 60 --cm-per-px 2 --yaw 0.12 \\
      --out calib.json

  # headless from EDGE LINES: 4 lines in order around the tile (top,
  # right, bottom, left), two points each; the corners are where
  # consecutive lines intersect
  python scripts/torch_calibrate.py --edges 200,160 320,162  318,165 \\
      335,240  330,238 180,244  188,246 205,158 --out calib.json ...

  # interactive: C = calibrate from the clicked corners, E = edge mode
  # (8 clicks = 4 lines of 2 points), S = save, Q = quit
  python scripts/torch_calibrate.py --camera 0 --out calib.json ...
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def parse_pair(s, cast=float):
    a, b = s.replace("x", ",").split(",")
    return (cast(a), cast(b))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--corners", nargs=4, metavar="X,Y",
                   help="4 fiducial corners in the camera image (headless)")
    p.add_argument("--edges", nargs=8, metavar="X,Y",
                   help="4 tile edge lines (2 points each, lines in order "
                        "around the tile); the corners are recovered by "
                        "intersecting consecutive lines")
    p.add_argument("--camera", type=int, help="camera index (interactive)")
    p.add_argument("--input-size", default="512x256",
                   help="segmap WxH fed to the grid builder")
    p.add_argument("--output-size", default="512x512", help="BEV WxH")
    p.add_argument("--dist2target", default="0,100",
                   help="camera->fiducial distance cm (x,y)")
    p.add_argument("--tile-length", type=float, default=60.0,
                   help="fiducial edge length, cm")
    p.add_argument("--cm-per-px", type=float, default=2.0)
    p.add_argument("--yaw", type=float, default=0.0, help="radians")
    p.add_argument("--laserscan", action="store_true")
    p.add_argument("--out", required=True, help="calibration JSON path")
    args = p.parse_args(argv)
    if args.corners and args.edges:
        p.error("--corners and --edges are mutually exclusive")
    if not (args.corners or args.edges) and args.camera is None:
        p.error("need --corners/--edges (headless) or --camera "
                "(interactive)")
    return args


def run(args) -> int:
    from bugcar_image_segmentation_tpu_torch import geometry
    from bugcar_image_segmentation_tpu_torch.calibration import BEVTransform

    bev = BEVTransform(
        input_shape=parse_pair(args.input_size, int),
        output_shape=parse_pair(args.output_size, int),
        dist2target=parse_pair(args.dist2target),
        tile_length=args.tile_length,
        cm_per_px=args.cm_per_px,
        yaw=args.yaw,
        laserscan=args.laserscan,
    )
    if args.corners or args.edges:
        if args.corners:
            corners = np.array([parse_pair(c) for c in args.corners])
        else:
            pts = [parse_pair(c) for c in args.edges]
            corners = geometry.corners_from_edge_lines(
                [(pts[2 * i], pts[2 * i + 1]) for i in range(4)])
            print(f"corners from edge intersections:\n{corners}")
        # The solver pairs corners positionally with the BEV side's order
        # (geometry.bev_tile_corners): any click or edge order is put in
        # that order first.
        corners = geometry.order_corners_for_calibration(corners, args.yaw)
        m = bev.calculate_transform_matrix(corners)
        bev.save_to_json(args.out)
        print(f"saved {args.out}\nmatrix:\n{m}")
        return 0
    return interactive(args, bev, geometry)


def interactive(args, bev, geometry) -> int:
    """Click the corners (or edge points) on the live camera."""
    try:
        import cv2
    except ImportError:
        print("--camera needs cv2, which is not installed here; give the "
              "corners with --corners or --edges", file=sys.stderr)
        return 2
    clicked = []
    mode = {"edges": False}     # E toggles corner clicks / edge clicks

    def on_mouse(event, x, y, flags, param):
        limit = 8 if mode["edges"] else 4
        if event == cv2.EVENT_LBUTTONDOWN and len(clicked) < limit:
            clicked.append((float(x), float(y)))

    cap = cv2.VideoCapture(args.camera)
    if not cap.isOpened():
        print(f"cannot open camera {args.camera}", file=sys.stderr)
        return 1
    cv2.namedWindow("calibrate")
    cv2.setMouseCallback("calibrate", on_mouse)
    print("click the 4 fiducial corners (E = edge mode: click 8 points = 4 "
          "lines in order around the tile); C = calibrate, S = save, "
          "Q = quit")
    calibrated = False
    while True:
        ok, frame = cap.read()
        if not ok:
            continue
        for c in clicked:
            cv2.circle(frame, (int(c[0]), int(c[1])), 4, (0, 255, 0), -1)
        if mode["edges"]:
            for i in range(len(clicked) // 2):
                a, b = clicked[2 * i], clicked[2 * i + 1]
                cv2.line(frame, (int(a[0]), int(a[1])),
                         (int(b[0]), int(b[1])), (0, 255, 255), 1)
        cv2.imshow("calibrate", frame)
        key = cv2.waitKey(1) & 0xFF
        if key == ord("q"):
            break
        if key == ord("e"):
            mode["edges"] = not mode["edges"]
            clicked.clear()
            print("edge mode " + ("ON (8 clicks = 4 lines)" if mode["edges"]
                                  else "OFF (4 corner clicks)"))
        need = 8 if mode["edges"] else 4
        if key == ord("c") and len(clicked) == need:
            if mode["edges"]:
                corners = geometry.corners_from_edge_lines(
                    [(clicked[2 * i], clicked[2 * i + 1]) for i in range(4)])
                print("corners from edge intersections:\n", corners)
            else:
                corners = np.array(clicked)
            corners = geometry.order_corners_for_calibration(corners,
                                                             args.yaw)
            bev.calculate_transform_matrix(corners)
            calibrated = True
            print("calibrated:\n", bev.matrix)
        if key == ord("s") and calibrated:
            bev.save_to_json(args.out)
            print(f"saved {args.out}")
    cap.release()
    cv2.destroyAllWindows()
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
