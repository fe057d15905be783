"""Inference engines: uint8 BGR frame → class map, on the device.

Port of ``bugcar_image_segmentation_tpu/models/api.py`` (``Engine`` and
``build_engine``; the reference's ``InferenceModel``/``ENET``, models.py:
8-136) for the ENet executors of this slice:

- ``"enet"``: the :class:`~.enet.ENet` module, plain PyTorch ops;
- ``"enet_fused"``: the same parameters with the 16 trunk bottlenecks as
  hand-written CUDA kernels (:class:`~.enet_fused.FusedENet`).

An engine runs ``preprocess → backbone → argmax → 3-class remap`` on its
device.  Weights come as a Flax-layout numpy tree (``{"params",
"batch_stats"}``, bridged by ``convert/flax_enet.py``), as a port
``state_dict``, or — absent both — from ``seed``.  The parameters live in
float32; BatchNorm is folded in f32 and the module is then cast to the
config's compute dtype.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from ..configs import ModelConfig
from ..convert.flax_enet import enet_state_dict
from . import preprocess as pre
from . import remap
from .enet import ENet
from .enet_fused import FusedENet

EXECUTORS = ("enet", "enet_fused")


def frames_to_device(frames_bgr, device: torch.device) -> torch.Tensor:
    """uint8 BGR frame(s) (array or tensor) as a tensor on ``device``."""
    t = torch.as_tensor(frames_bgr)
    if t.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8 BGR, got {t.dtype}")
    return t.to(device, non_blocking=True)


class Engine:
    """A segmentation backbone behind a frame → class-map API.

    Args:
      name: "enet" or "enet_fused".
      cfg: model geometry, normalisation constants and compute dtype.
      variables: a Flax-layout numpy variable tree, or a port state dict;
        None initialises from ``seed``.
      device: where the model runs ("cuda" unless a caller asks for CPU).
      seed: the ``torch.Generator`` seed of a self-initialised engine.
    """

    def __init__(self, name: str, cfg: ModelConfig,
                 variables: Optional[Mapping] = None,
                 device="cuda", seed: int = 0):
        if name not in EXECUTORS:
            raise NotImplementedError(
                f"model {name!r} is not ported yet; this slice has "
                f"{EXECUTORS}")
        self.name = name
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.remap_table = remap.remap_table(cfg.num_classes)
        self.seed = seed
        self.load_variables(variables)

    def load_variables(self, variables: Optional[Mapping]) -> None:
        """Swap in weights: a Flax-layout tree, a port state dict, or None
        (random from the engine's seed)."""
        enet = ENet(self.cfg.num_classes)
        if variables is None:
            enet.reset_parameters(torch.Generator().manual_seed(self.seed))
        else:
            sd = (enet_state_dict(variables) if "params" in variables
                  else variables)
            enet.load_state_dict(sd)
        enet = enet.to(self.device).eval()
        # Fused kernel arguments come from the f32 parameters; then the
        # module is cast to the compute dtype in place.
        forward: Callable = (FusedENet(enet) if self.name == "enet_fused"
                             else enet)
        enet.to(self.dtype)
        self.module = enet
        self.forward_fn = forward

    # -- the device program --------------------------------------------------

    @torch.no_grad()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 BGR on the device → (N, h, w, C) f32 logits."""
        x = pre.preprocess_for_config(frames, self.cfg)
        return self.forward_fn(x)

    @torch.no_grad()
    def segment(self, frames: torch.Tensor, mode: str = "multiclass"
                ) -> torch.Tensor:
        """(N, H, W, 3) uint8 on the device → (N, h, w) uint8 class maps
        (3-class drivability, or the binary road mask)."""
        logits = self.forward(frames)
        if mode == "multiclass":
            return remap.logits_to_drivability(logits, self.remap_table)
        if mode == "binary":
            return remap.logits_to_binary_road(logits)
        raise ValueError(f"unknown mode {mode!r}")

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
    """Engine by name: ``"enet"`` or ``"enet_fused"`` (the others of the
    JAX package's zoo come with later slices)."""
    name = name.lower()
    cfg = cfg or ModelConfig(name=name)
    return Engine(name, cfg, variables=variables, device=device, seed=seed)


__all__ = ["Engine", "build_engine", "frames_to_device", "EXECUTORS"]
