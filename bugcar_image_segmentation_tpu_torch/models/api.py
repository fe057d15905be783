"""Inference engines: uint8 BGR frame → class map, on the device.

Port of ``bugcar_image_segmentation_tpu/models/api.py`` (``Engine`` and
``build_engine``; the reference's ``InferenceModel``/``ENET``, models.py:
8-136) for the models of the ported slices:

- ``"enet"``: the :class:`~.enet.ENet` module, plain PyTorch ops;
- ``"enet_fused"``: the same parameters with the 16 trunk bottlenecks as
  hand-written CUDA kernels (:class:`~.enet_fused.FusedENet`);
- ``"segformer[_bN][_q][_int8][_hc]"`` (flags in any order):
  :class:`~.segformer.SegFormer` B0 (default) to B3, attention through
  the hand-written CUDA kernel; ``_q`` keeps the head at 1/4 resolution
  (argmax there, labels nearest-lifted; see :attr:`Engine.label_scale`),
  ``_int8`` runs the Dense products that clear the W8A8 gate on int8
  (``ops/quant.py``), ``_hc`` sums the head's parts as a cascade; both
  take the JAX engine's folded head;
- ``"[deeplab_]xception[_q][_int8][_fs]"``: DeepLabV3+ on Xception-65
  (:class:`~.xception.Xception65DeepLab`); ``_fs`` runs the 55 dilation-1
  separable convs of the entry and middle flows through the hand-written
  CUDA kernel, ``_q`` as for SegFormer, ``_int8`` the pointwise 1x1s
  with C and F >= 512 on int8 (and, as in the JAX package, no sepconv
  through the kernel);
- ``"deeplab[_q]"``: DeepLabV3+ over MobileNetV2
  (:class:`~.deeplab.DeepLabV3`, BASELINE config 2's ``deeplab.pb``
  model), 1024x512 by default, ``_q`` as for SegFormer;
- ``"unet"`` and ``"unet_ph"``: :class:`~.unet.UNet` (BASELINE config 3),
  512x256 by default; ``unet_ph`` is the JAX package's 2x2 phase-space
  layout of the same sums, the same module here.

Any name takes the suffix ``_w16`` (``"enet_w16"``, the engine
``bench.py`` serves; ``"enet_fused_w16"``, ``"segformer_b0_w16"``,
``"xception_fs_w16"``): the engine serves from weights rounded to
bfloat16 at load, as the JAX package's ``Engine.cache_weights`` stores
them.  ENet then folds its BatchNorms from the rounded leaves where and as
the JAX engine does (:meth:`~.enet.ENet.round_weights_bf16`); the fused
trunk gets the f32 values of that fold.

An engine runs ``preprocess → backbone → argmax → 3-class remap`` on its
device.  Weights come as a Flax-layout numpy tree (``{"params",
"batch_stats"}``, bridged by ``convert/``), as a port ``state_dict``, or —
absent both — from ``seed``.  Parameters are loaded in float32; ENet folds
BatchNorm in f32 and is then cast to the config's compute dtype, SegFormer
and Xception cast their Dense and conv weights and keep their norms in
f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..configs import ModelConfig
from ..convert.flax_deeplab import deeplab_state_dict, random_deeplab_variables
from ..convert.flax_enet import enet_state_dict
from ..convert.flax_segformer import (random_segformer_variables,
                                      segformer_state_dict)
from ..convert.flax_unet import random_unet_variables, unet_state_dict
from ..convert.flax_xception import (random_xception_variables,
                                     xception_state_dict)
from ..ops.resize import upsample_nearest_int
from . import preprocess as pre
from . import remap
from .deeplab import DeepLabV3
from .enet import ENet
from .enet_fused import FusedENet
from .segformer import SEGFORMER_PRESETS, SegFormer
from .unet import UNet
from .xception import Xception65DeepLab

EXECUTORS = ("enet", "enet_fused")     # the ENet engines
DEEPLAB = ("deeplab", "deeplab_q")     # MobileNetV2 DeepLab; _q: quarter head
UNETS = ("unet", "unet_ph")            # the same UNet (_ph: a TPU layout)
W16 = "_w16"      # suffix: serve from bf16-rounded weights


def _split_w16(name: str) -> Tuple[str, bool]:
    """``"<engine>[_w16]"`` → (engine name, weights rounded to bf16)."""
    if name.endswith(W16):
        return name[:-len(W16)], True
    return name, False


def _round_bf16(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict with every float tensor rounded to a bf16 value (kept
    in f32), as ``Engine.cache_weights`` casts the Flax tree."""
    return {k: (v.to(torch.bfloat16).float() if v.is_floating_point()
                else v) for k, v in sd.items()}


SEGFORMER_FLAGS = ("q", "int8", "hc")
XCEPTION_FLAGS = ("q", "int8", "fs")


def segformer_variant(name: str) -> Tuple[str, bool, bool, bool]:
    """``"segformer[_size][_q][_int8][_hc]"``, flags in any order → (size,
    quarter head, int8, head cascade)."""
    tokens = name.split("_")[1:]
    rest = [t for t in tokens if t not in SEGFORMER_FLAGS]
    if len(rest) > 1 or (rest and rest[0] not in SEGFORMER_PRESETS):
        raise ValueError(
            f"unknown SegFormer variant {name!r}; grammar is "
            f"segformer[_size][_q][_int8][_hc] with size in "
            f"{sorted(SEGFORMER_PRESETS)}")
    return ((rest[0] if rest else "b0"),) + tuple(
        f in tokens for f in SEGFORMER_FLAGS)


def _is_segformer(name: str) -> bool:
    return name == "segformer" or name.startswith("segformer_")


def _is_xception(name: str) -> bool:
    return (name in ("deeplab_xception", "xception")
            or name.startswith(("deeplab_xception_", "xception_")))


def xception_variant(name: str) -> Tuple[bool, bool, bool]:
    """``"[deeplab_]xception[_q][_int8][_fs]"``, flags in any order →
    (quarter head, int8 pointwise, fused sepconvs)."""
    tokens = name.replace("deeplab_xception", "xception").split("_")[1:]
    if any(t not in XCEPTION_FLAGS for t in tokens):
        raise ValueError(f"unknown Xception variant {name!r}; grammar is "
                         f"[deeplab_]xception[_q][_int8][_fs]")
    return tuple(f in tokens for f in XCEPTION_FLAGS)


def frames_to_device(frames_bgr, device: torch.device) -> torch.Tensor:
    """uint8 BGR frame(s) (array or tensor) as a tensor on ``device``."""
    t = torch.as_tensor(frames_bgr)
    if t.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8 BGR, got {t.dtype}")
    return t.to(device, non_blocking=True)


class Engine:
    """A segmentation backbone behind a frame → class-map API.

    Args:
      name: "enet", "enet_fused", "segformer[_bN][_q][_int8][_hc]",
        "[deeplab_]xception[_q][_int8][_fs]", "deeplab[_q]", "unet" or
        "unet_ph", each optionally with ``_w16``
        (weights rounded to bf16 at load).
      cfg: model geometry, normalisation constants and compute dtype.
      variables: a Flax-layout numpy variable tree, or a port state dict;
        None initialises from ``seed``.
      device: where the model runs ("cuda" unless a caller asks for CPU).
      seed: the seed of a self-initialised engine.

    ``label_scale``: the head emits labels at 1/label_scale of the input
    resolution (4 for ``_q``); :meth:`segment` lifts them back,
    :meth:`segment_head` does not.

    ``frame_by_frame`` (True for SegFormer and UNet): the backbone takes
    the frames of a batch one at a time (see :meth:`forward`); False runs
    the whole batch in one call.

    ``int8`` and ``cascade``: the name's ``_int8`` and ``_hc`` flags.

    ``placer`` (None, or set by ``parallel/tp.py`` / ``parallel/spatial.py``)
    places the weights on a mesh; :meth:`load_variables` applies it to the
    new weights.  ``spatial`` (a ``parallel/halo.RowShards``, set by
    ``parallel/spatial.py``): each frame's rows are split over ranks; the
    backbone runs on this rank's rows, and :meth:`forward` and
    :meth:`segment_head` return the whole frame's, gathered.
    """

    placer: Optional[Callable] = None
    spatial = None

    def __init__(self, name: str, cfg: ModelConfig,
                 variables: Optional[Mapping] = None,
                 device="cuda", seed: int = 0):
        self.size: Optional[str] = None
        self.family = "enet"
        base, self.weights_bf16 = _split_w16(name)
        quarter = self.int8 = self.cascade = False
        if _is_segformer(base):
            self.family = "segformer"
            self.size, quarter, self.int8, self.cascade = \
                segformer_variant(base)
        elif _is_xception(base):
            self.family = "xception"
            quarter, self.int8, self.fused = xception_variant(base)
        elif base in DEEPLAB:
            self.family, quarter = "deeplab", base == "deeplab_q"
        elif base in UNETS:
            self.family = "unet"
        elif base not in EXECUTORS:
            raise ValueError(
                f"unknown model {name!r}; the port has {EXECUTORS}, "
                f"{DEEPLAB}, {UNETS}, segformer[_b0|_b1|_b2|_b3][_q][_int8]"
                f"[_hc] and [deeplab_]xception[_q][_int8][_fs], each also "
                f"with {W16}")
        self.base_name = base
        self.label_scale = 4 if quarter else 1
        self.name = name
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.remap_table = remap.remap_table(cfg.num_classes)
        self.seed = seed
        # In bf16 on the card SegFormer's and UNet's whole-batch forwards
        # give a frame other logits than it gets alone (SegFormer's first
        # conv, UNet's enc2.conv0 already differ); ENet's, Xception's and
        # the MobileNetV2 DeepLab's give the same logits (at most an ENet
        # deconv's intermediate differs), and frame by frame would cost
        # them 1.2-3x a 4-frame batch's time (measured with
        # scripts/torch_batch_invariance.py).
        self.frame_by_frame = self.family in ("segformer", "unet")
        self.load_variables(variables)

    def load_variables(self, variables: Optional[Mapping]) -> None:
        """Swap in weights: a Flax-layout tree, a port state dict, or None
        (random from the engine's seed); ``_w16`` rounds them to bf16;
        the engine's ``placer`` places them."""
        self._load(variables)
        if self.placer is not None:
            self.placer(self)

    def _load(self, variables: Optional[Mapping]) -> None:
        quarter = "quarter" if self.label_scale == 4 else "full"
        if self.family == "segformer":
            self._load_module(
                SegFormer.preset(self.size, num_classes=self.cfg.num_classes,
                                 head_upsample=quarter, quant=self.int8,
                                 head_cascade=self.cascade),
                segformer_state_dict,
                lambda seed, num_classes: random_segformer_variables(
                    seed, self.size, num_classes), variables)
            return
        if self.family == "deeplab":
            self._load_module(DeepLabV3(self.cfg.num_classes, quarter),
                              deeplab_state_dict, random_deeplab_variables,
                              variables)
            return
        if self.family == "unet":
            self._load_module(UNet(self.cfg.num_classes), unet_state_dict,
                              random_unet_variables, variables)
            return
        if self.family == "xception":
            self._load_xception(variables)
            return
        enet = ENet(self.cfg.num_classes)
        if variables is None:
            enet.reset_parameters(torch.Generator().manual_seed(self.seed))
        else:
            sd = (enet_state_dict(variables) if "params" in variables
                  else variables)
            enet.load_state_dict(sd)
        if self.weights_bf16:
            enet.round_weights_bf16()
        enet = enet.to(self.device).eval()
        # Fused kernel arguments come from the f32 parameters and folds;
        # then the module is cast to the compute dtype in place.
        forward: Callable = (FusedENet(enet)
                             if self.base_name == "enet_fused" else enet)
        enet.to(self.dtype)
        self.module = enet
        self.forward_fn = forward

    def _load_module(self, model, to_state_dict: Callable,
                     make_random: Callable,
                     variables: Optional[Mapping]) -> None:
        """Load a Flax tree (through its bridge), a state dict or seeded
        weights into ``model``, move it to the device and cast its convs
        to the compute dtype."""
        if variables is None:
            variables = make_random(self.seed,
                                    num_classes=self.cfg.num_classes)
        sd = to_state_dict(variables) if "params" in variables else variables
        model.load_state_dict(_round_bf16(sd) if self.weights_bf16 else sd)
        self.module = model.to(self.device).eval().to_compute_dtype(
            self.dtype)
        self.forward_fn = self.module

    def _load_xception(self, variables: Optional[Mapping]) -> None:
        if variables is None:
            variables = random_xception_variables(
                self.seed, num_classes=self.cfg.num_classes)
        sd = (xception_state_dict(variables) if "params" in variables
              else variables)
        middle = sum(1 for k in sd if k.startswith("middle")
                     and k.endswith(".sep0.depthwise.weight"))
        model = Xception65DeepLab(
            num_classes=self.cfg.num_classes, middle_blocks=middle,
            head_upsample="quarter" if self.label_scale == 4 else "full",
            fused_sepconv=self.fused, pw_int8=self.int8)
        model.load_state_dict(_round_bf16(sd) if self.weights_bf16 else sd)
        self.module = model.to(self.device).eval().to_compute_dtype(
            self.dtype)
        self.forward_fn = self.module

    # -- the device program --------------------------------------------------

    @torch.no_grad()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 BGR on the device → (N, h, w, C) f32 logits.

        A frame's logits are the same alone, in a batch or in a stream,
        bit for bit.  cuBLAS and cuDNN choose their GEMM and convolution
        algorithms by the batch size, and in bf16 the other summation
        orders flip argmax near-ties; where that happens (SegFormer-B0's
        first conv already differs, and no setting controls it) the
        engine runs the backbone one frame at a time
        (:attr:`frame_by_frame`).  Preprocessing,
        argmax, remap and grid stay batched (they are elementwise or
        gather per frame)."""
        return self._whole(self._shard_logits(frames))

    def _shard_logits(self, frames: torch.Tensor) -> torch.Tensor:
        """The backbone's logits; under :attr:`spatial`, of this rank's
        rows of the preprocessed frames."""
        x = pre.preprocess_for_config(frames, self.cfg)
        if self.spatial is not None:
            x = self.spatial.take(x, 1)
        if not self.frame_by_frame or x.shape[0] == 1:
            return self.forward_fn(x)
        return torch.cat([self.forward_fn(x[i:i + 1])
                          for i in range(x.shape[0])])

    def _whole(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``y`` under :attr:`spatial`, else ``y``."""
        return y if self.spatial is None else self.spatial.gather(y, 1)

    @torch.no_grad()
    def segment_head(self, frames: torch.Tensor, mode: str = "multiclass"
                     ) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device → (N, h, w) uint8 class maps
        (3-class drivability, or the binary road mask) at the head's
        resolution, 1/label_scale of the input's."""
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"unknown mode {mode!r}")
        logits = self._shard_logits(frames)
        if mode == "multiclass":
            labels = remap.logits_to_drivability(logits, self.remap_table)
        else:
            labels = remap.logits_to_binary_road(logits)
        return self._whole(labels)

    def to_input_res(self, labels: torch.Tensor) -> torch.Tensor:
        """Nearest-lift a head-resolution label map to the input
        resolution (identity when ``label_scale`` is 1)."""
        return upsample_nearest_int(labels, self.label_scale)

    @torch.no_grad()
    def segment(self, frames: torch.Tensor, mode: str = "multiclass"
                ) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device → (N, h, w) uint8 class maps
        at the model's input resolution."""
        return self.to_input_res(self.segment_head(frames, mode))

    # -- public API (reference models.py:42/70 equivalents) ------------------

    def _batched(self, fn: Callable, frames_bgr) -> torch.Tensor:
        frames = frames_to_device(frames_bgr, self.device)
        if frames.dim() == 3:
            return fn(frames[None])[0]
        return fn(frames)

    def predict(self, frames_bgr) -> torch.Tensor:
        """BGR uint8 frame(s) (H, W, 3) or (B, H, W, 3) → uint8 3-class
        drivability map(s) at the model's input resolution."""
        return self._batched(self.segment, frames_bgr)

    def predict_binary(self, frames_bgr) -> torch.Tensor:
        """BGR uint8 frame(s) → uint8 {0,1} road mask(s)
        (reference models.py:70-82)."""
        return self._batched(lambda f: self.segment(f, "binary"),
                             frames_bgr)

    def logits(self, frames_bgr) -> torch.Tensor:
        """Raw f32 class logits, NHWC."""
        return self._batched(self.forward, frames_bgr)


def build_engine(name: str = "enet",
                 cfg: Optional[ModelConfig] = None,
                 variables: Optional[Mapping] = None,
                 device="cuda", seed: int = 0) -> Engine:
    """Engine by name: ``"enet"``, ``"enet_fused"``,
    ``"segformer[_b0|_b1|_b2|_b3][_q][_int8][_hc]"``,
    ``"[deeplab_]xception[_q][_int8][_fs]"``, ``"deeplab[_q]"``,
    ``"unet"`` or ``"unet_ph"``, each optionally with ``_w16``, the names
    the JAX package's ``build_engine`` takes.  SegFormer defaults to
    1024x1024, both DeepLabs to 1024x512 and UNet to 512x256 (W x H), as
    the JAX package's."""
    name = name.lower()
    if cfg is None:
        base, _ = _split_w16(name)
        if _is_segformer(base):
            cfg = ModelConfig(name=base, input_width=1024,
                              input_height=1024, num_classes=15)
        elif _is_xception(base):
            cfg = ModelConfig(name="deeplab_xception", input_width=1024,
                              input_height=512, num_classes=15)
        elif base in DEEPLAB:
            cfg = ModelConfig(name=base, input_width=1024, input_height=512,
                              num_classes=15)
        elif base in UNETS:
            cfg = ModelConfig(name="unet", input_width=512, input_height=256,
                              num_classes=15)
        else:
            cfg = ModelConfig(name=base)
    return Engine(name, cfg, variables=variables, device=device, seed=seed)


__all__ = ["Engine", "build_engine", "frames_to_device", "segformer_variant",
           "xception_variant", "EXECUTORS", "DEEPLAB", "UNETS"]
