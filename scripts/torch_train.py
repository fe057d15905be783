#!/usr/bin/env python3
"""Train / fine-tune a segmentation backbone with the PyTorch port.

The port's counterpart of scripts/train.py, with its flags and loop: the
same ``np.random.default_rng(0)`` batch draws, augmentation and dropout
from two disjoint seeded streams, bf16 activations over f32 master
weights, ``optax.adamw``'s update and schedules (``training/optim.py``),
and a Flax msgpack checkpoint at the end (``save_variables``; the JAX
package's ``load_variables`` reads it).

  python scripts/torch_train.py --model enet --images data/imgs \\
      --labels data/lbls --steps 1000 --batch 16 --lr 3e-4 --out ckpt.msgpack

It runs on the card unless ``--device cpu`` is given.  Data parallel over
N cards: ``torchrun --nproc-per-node N scripts/torch_train.py --devices N
...`` (every rank draws the global batch and takes its shard; rank 0
logs and writes the checkpoint).  Add ``--spatial K`` to also split each
image's rows over K of them (``parallel/spatial.py``): the mesh becomes
(N/K data) x (K space), for resolutions whose activations do not fit one
card.

Images and labels pair by sorted filename: ``.npy`` files (uint8 BGR
(H, W, 3) frames and (H, W) class ids), which is all the card host can
read, or images PNG/JPEG and label PNGs where cv2 is installed.  Labels
are resized to the model's input by nearest neighbour, as cv2's
``INTER_NEAREST`` does.
"""

import argparse
import logging
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

MODELS = ("enet", "deeplab", "unet", "segformer")


def build_model(name: str, num_classes: int):
    """The port's module for ``--model`` and the bridge from a Flax tree."""
    from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import \
        deeplab_state_dict
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        enet_state_dict
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        segformer_state_dict
    from bugcar_image_segmentation_tpu_torch.convert.flax_unet import \
        unet_state_dict
    from bugcar_image_segmentation_tpu_torch.models.deeplab import DeepLabV3
    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.models.segformer import \
        SegFormer
    from bugcar_image_segmentation_tpu_torch.models.unet import UNet

    return {
        "enet": (lambda: ENet(num_classes), enet_state_dict),
        "deeplab": (lambda: DeepLabV3(num_classes), deeplab_state_dict),
        "unet": (lambda: UNet(num_classes), unet_state_dict),
        "segformer": (lambda: SegFormer.preset("b0",
                                               num_classes=num_classes),
                      segformer_state_dict),
    }[name]


def read_pair(image_path: str, label_path: str, hw):
    """(uint8 BGR frame, int32 label resized to ``hw`` by nearest)."""
    def read(path, gray):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            import cv2
        except ImportError:
            raise SystemExit(f"{path}: only .npy files can be read without "
                             f"cv2") from None
        flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        return cv2.imread(path, flag)

    frame, label = read(image_path, False), read(label_path, True)
    h, w = hw
    ys = np.minimum((np.arange(h) * (label.shape[0] / h)).astype(int),
                    label.shape[0] - 1)
    xs = np.minimum((np.arange(w) * (label.shape[1] / w)).astype(int),
                    label.shape[1] - 1)
    return frame, label[ys][:, xs].astype(np.int32)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--model", default="enet", choices=MODELS)
    p.add_argument("--images", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=15)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", choices=["constant", "cosine"],
                   default="constant",
                   help="LR schedule (cosine = linear warmup + cosine decay "
                        "to 0 over --steps)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--augment", action="store_true",
                   help="flip / zoom / colour jitter (training/augment.py)")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel ranks (launch with torchrun "
                        "--nproc-per-node N)")
    p.add_argument("--spatial", type=int, default=1,
                   help="also shard each image's rows over this many of "
                        "the --devices ranks (spatial partitioning): the "
                        "mesh becomes (devices/N) data x N space")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--out", required=True, help="msgpack checkpoint path")
    p.add_argument("--resume", help="msgpack checkpoint to start from")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if args.spatial > 1:
        if args.devices % args.spatial:
            p.error(f"--spatial {args.spatial} does not divide the "
                    f"{args.devices} devices")
        if args.height % args.spatial:
            p.error(f"--spatial {args.spatial} does not divide the image "
                    f"height {args.height}")

    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
        flax_variables
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.training import (
        AdamW, create_train_state, make_train_step, warmup_constant,
        warmup_cosine_decay)
    from bugcar_image_segmentation_tpu_torch.training.augment import (
        AugmentConfig, augment_batch)
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import (
        load_variables, save_variables)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("torch_train")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA card here; pass --device cpu to train on the CPU")

    mesh = None
    if args.devices > 1 or "WORLD_SIZE" in os.environ:
        if int(os.environ.get("WORLD_SIZE", 1)) != args.devices:
            p.error(f"--devices {args.devices}: launch with torchrun "
                    f"--nproc-per-node {args.devices}")
        from bugcar_image_segmentation_tpu_torch.parallel import (
            make_mesh, replicate, shard_batch, shard_batch_spatial)
        data = args.devices // args.spatial
        if args.batch % data:
            p.error(f"--batch {args.batch} does not divide over {data} "
                    f"data ranks")
        mesh = make_mesh(args.devices, axes=("data", "space"),
                         shape=(data, args.spatial), device=args.device)
        device = mesh.device
        place = shard_batch_spatial if args.spatial > 1 else shard_batch
    else:
        device = torch.device(args.device)
    lead = mesh is None or mesh.rank == 0

    cfg = port.ModelConfig(name=args.model, input_width=args.width,
                           input_height=args.height,
                           num_classes=args.num_classes, dtype="bfloat16")
    make, bridge = build_model(args.model, args.num_classes)
    model = make()
    model.compute_dtype = getattr(torch, cfg.dtype)

    img_files = sorted(os.listdir(args.images))
    lbl_files = sorted(os.listdir(args.labels))
    if not img_files or len(img_files) != len(lbl_files):
        p.error("dataset empty or images and labels mismatched")
    hw = (args.height, args.width)

    if args.schedule == "cosine":
        lr = warmup_cosine_decay(args.lr, max(args.warmup_steps, 1),
                                 args.steps)
    else:
        lr = (warmup_constant(args.lr, args.warmup_steps)
              if args.warmup_steps else args.lr)
    state = create_train_state(model, (1,) + hw + (3,),
                               optimizer=AdamW(lr), seed=args.seed,
                               device=device)
    if args.resume:
        variables, _ = load_variables(args.resume)
        model.load_state_dict(bridge(variables))
    if mesh is not None:
        replicate(state, mesh)
    train_step = make_train_step(model, mesh=mesh)

    rng = np.random.default_rng(0)
    aug_gen = torch.Generator().manual_seed(args.seed)
    drop_gen = torch.Generator().manual_seed(args.seed + 1)
    acfg = AugmentConfig(ignore_label=255)

    def batch():
        idx = rng.integers(0, len(img_files), size=args.batch)
        pairs = [read_pair(os.path.join(args.images, img_files[i]),
                           os.path.join(args.labels, lbl_files[i]), hw)
                 for i in idx]
        return (np.stack([f for f, _ in pairs]),
                np.stack([lb for _, lb in pairs]))

    def preprocess(frames, labels):
        frames = torch.from_numpy(frames).to(device)
        labels = torch.from_numpy(labels).to(device)
        if not args.augment:
            return pre.preprocess_for_config(frames, cfg), labels
        # [0, 1] floats for the photometric knobs, then normalise
        x = pre.preprocess_frame(frames, hw, mean=(0.0, 0.0, 0.0),
                                 std=(1.0, 1.0, 1.0), dtype=torch.float32)
        x, labels = augment_batch(aug_gen, x, labels, acfg)
        mean = torch.tensor(cfg.image_mean, device=device)
        std = torch.tensor(cfg.image_std, device=device)
        return ((x - mean) / std).to(getattr(torch, cfg.dtype)), labels

    for step in range(args.steps):
        images, labels = preprocess(*batch())
        if mesh is not None:
            images, labels = place((images, labels), mesh)
        state, loss = train_step(state, images, labels, drop_gen)
        if lead and step % args.log_every == 0:
            log.info("step %d loss %.4f", step, float(loss))

    if lead:
        save_variables(args.out, flax_variables(model), cfg)
        log.info("saved %s", args.out)
    if mesh is not None:
        mesh.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
