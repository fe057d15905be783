#!/usr/bin/env python3
"""Freeze an engine or a whole frame→grid pipeline of the PyTorch port
into a deploy artifact, or inspect one.

The port's counterpart of scripts/export_model.py, with its flags: weights
baked in, a ``torch.export`` program in the port's container
(``deploy.py``), loadable with torch and the port's kernel ops alone.

  # freeze a model endpoint (symbolic batch by default)
  python scripts/torch_export_model.py --model enet --out enet.bcseg \\
      [--checkpoint ckpt.msgpack] [--fn predict|predict_binary|logits] \\
      [--batch N] [--device cuda|cpu]

  # freeze the frame→grid pipeline for one calibration
  python scripts/torch_export_model.py --model enet --out pipe.bcseg \\
      --calibration cal.json [--mode multiclass|binary] \\
      [--interpolation cv2_linear|native]

  # inspect / smoke-run an artifact
  python scripts/torch_export_model.py --load pipe.bcseg [--smoke]

  # a spatially partitioned engine for K ranks (rows of a frame split
  # over them, parallel/spatial.py); rank 0 writes the artifact
  torchrun --nproc-per-node K scripts/torch_export_model.py --model enet \
      --out enet_sp.bcseg --spatial K --batch 1
  # its smoke run, on as many ranks as it was exported for
  torchrun --nproc-per-node K scripts/torch_export_model.py \
      --load enet_sp.bcseg --smoke

The program is exported for the device it runs on: the card unless
``--device cpu`` (or ``--platforms cpu``) is given.  SegFormer and UNet
engines, which run frame by frame, need ``--batch``.
"""

import argparse
import json
import re
import sys

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--model", default="enet")
    p.add_argument("--checkpoint")
    p.add_argument("--out")
    p.add_argument("--fn", default="predict",
                   choices=["predict", "predict_binary", "logits"])
    p.add_argument("--batch", type=int, default=None,
                   help="static batch size (default: symbolic)")
    p.add_argument("--platforms",
                   help="the one device to export for, cuda or cpu "
                        "(default: --device)")
    p.add_argument("--calibration",
                   help="calibration JSON: exports the frame→grid pipeline "
                        "instead of a bare engine endpoint")
    p.add_argument("--mode", default="multiclass",
                   choices=["multiclass", "binary"])
    p.add_argument("--interpolation", default="cv2_linear")
    p.add_argument("--grid-size", type=float, nargs=2, default=(20.0, 20.0),
                   metavar=("W_M", "H_M"))
    p.add_argument("--cell", type=float, default=0.1)
    p.add_argument("--spatial", type=int, default=1,
                   help="export a spatially partitioned program: each "
                        "frame's rows over this many ranks (launch with "
                        "torchrun --nproc-per-node K); run it on an "
                        "equal-sized mesh")
    p.add_argument("--load", help="inspect an existing artifact and exit")
    p.add_argument("--smoke", action="store_true",
                   help="with --load: run one zero input through it")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.spatial > 1 and args.calibration:
        p.error("--spatial exports an engine endpoint, not a pipeline")
    if args.platforms:
        platforms = args.platforms.split(",")
        if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
            p.error(f"--platforms takes one of cuda, cpu (a torch.export "
                    f"program runs on the device it was exported on), got "
                    f"{args.platforms!r}")
        args.device = platforms[0]
    if not args.load and not args.out:
        p.error("--out is required when exporting")
    return args


def _zeros(aval: str):
    """A zero input for a header aval such as ``uint8[s77, 32, 64, 3]``
    (a symbolic dimension taken as 1)."""
    import torch

    dtype, dims = re.fullmatch(r"(\w+)\[(.*)\]", aval).groups()
    shape = [int(d) if d.strip().isdigit() else 1
             for d in dims.split(",") if d.strip()]
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def run(args: argparse.Namespace) -> dict:
    """Export (and reload) or inspect; the artifact's header, with the
    smoke outputs' shapes under ``"smoke_outputs"`` for ``--smoke``."""
    from bugcar_image_segmentation_tpu_torch import deploy
    from bugcar_image_segmentation_tpu_torch.parallel import make_mesh

    if args.load:
        dep = deploy.load_artifact(args.load)
        meta = dict(dep.meta)
        print(json.dumps(meta, indent=2))
        if args.smoke and dep.nr_devices > 1:
            # the last input is the rank's coordinate (call_sharded's)
            mesh = make_mesh(dep.nr_devices, device=dep.device.type)
            try:
                out = dep.call_sharded(
                    mesh, *(_zeros(a) for a in meta["in_avals"][:-1]))
            finally:
                mesh.close()
        elif args.smoke:
            out = dep(*(_zeros(a) for a in meta["in_avals"]))
        if args.smoke:
            out = out if isinstance(out, tuple) else (out,)
            meta["smoke_outputs"] = [
                [list(o.shape), str(o.dtype).replace("torch.", "")]
                for o in out]
            print("smoke outputs:", meta["smoke_outputs"])
        return meta

    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables

    variables, cfg = None, None
    if args.checkpoint:
        # a checkpoint freezes at its own resolution, not the name's default
        variables, cfg = load_variables(args.checkpoint)
    mesh = None
    if args.spatial > 1:
        from bugcar_image_segmentation_tpu_torch.parallel import \
            shard_engine_spatial
        mesh = make_mesh(args.spatial, axes=("space",), device=args.device)
    engine = port.build_engine(args.model, cfg=cfg, variables=variables,
                               device=args.device)
    if mesh is not None:
        shard_engine_spatial(engine, mesh)
        try:
            if mesh.rank == 0:
                deploy.export_engine_to(args.out, engine, fn=args.fn,
                                        batch=args.batch)
            torch.distributed.barrier()
        finally:
            mesh.close()
    elif args.calibration:
        cal = port.CalibrationConfig.load_json(args.calibration)
        grid_cfg = port.GridConfig(width_m=args.grid_size[0],
                                   height_m=args.grid_size[1],
                                   cell_m=args.cell)
        pipe = port.Pipeline(engine, cal, grid_cfg, mode=args.mode,
                             interpolation=args.interpolation)
        deploy.export_pipeline_to(args.out, pipe)
    else:
        deploy.export_engine_to(args.out, engine, fn=args.fn,
                                batch=args.batch)
    meta = deploy.load_artifact(args.out).meta
    print(json.dumps(meta, indent=2))
    print(f"wrote {args.out}")
    return meta


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
