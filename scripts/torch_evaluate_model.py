#!/usr/bin/env python3
"""Accuracy / IoU of a segmentation backbone with the PyTorch port.

The port's counterpart of scripts/evaluate_model.py, with its flags and
JSON report: the engine runs over (frame, label) pairs and the
drivability-class accuracy and IoU are printed.

  python scripts/torch_evaluate_model.py --model enet \\
      --images data/imgs --labels data/labels [--raw-classes] \\
      [--checkpoint ckpt.msgpack] [--device cpu]

Images and labels pair by sorted filename and are read as
scripts/torch_train.py reads them: ``.npy`` files (uint8 BGR (H, W, 3)
frames, (H, W) class ids), which is all the GPU host can read, or image
files where cv2 is installed; labels are resized to the model's input by
nearest neighbour.  Labels are backbone class ids (note_label order)
unless ``--raw-classes`` says they are 3-class maps already.  It runs on
the card unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--model", default="enet",
                   choices=["enet", "deeplab", "unet", "segformer"])
    p.add_argument("--checkpoint")
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--raw-classes", action="store_true",
                   help="labels are already 3-class drivability maps")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def run(args) -> dict:
    """The metrics' summary (printed by :func:`main`)."""
    from torch_train import read_pair

    from bugcar_image_segmentation_tpu_torch.evaluation import \
        evaluate_model
    from bugcar_image_segmentation_tpu_torch.models.api import build_engine
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables

    variables = None
    if args.checkpoint:
        variables, _ = load_variables(args.checkpoint)
    engine = build_engine(args.model, variables=variables,
                          device=args.device)
    img_files = sorted(os.listdir(args.images))
    lbl_files = sorted(os.listdir(args.labels))
    if len(img_files) != len(lbl_files):
        raise SystemExit(f"count mismatch: {len(img_files)} images vs "
                         f"{len(lbl_files)} labels")
    hw = (engine.cfg.input_height, engine.cfg.input_width)

    def dataset():
        for fi, fl in zip(img_files, lbl_files):
            # predictions come out at the model's resolution; the labels
            # are resized to it
            yield read_pair(os.path.join(args.images, fi),
                            os.path.join(args.labels, fl), hw)

    return evaluate_model(engine, dataset(),
                          remap_labels=not args.raw_classes).summary()


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv)), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
