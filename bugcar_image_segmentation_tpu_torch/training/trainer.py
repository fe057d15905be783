"""Training: the loss, the train state and the train and eval steps.

Port of ``bugcar_image_segmentation_tpu/training/trainer.py``:

- :func:`softmax_cross_entropy`: class-weighted cross-entropy over (..., C)
  logits with an ignore label, ``sum(nll * w) / max(sum(w), 1)``;
- :class:`TrainState`: the model (its parameters are the f32 master
  weights, its BatchNorm buffers the running statistics), the optimizer,
  its state and the step;
- :func:`create_train_state`: Flax's initial values (LeCun-normal kernels,
  truncated as ``nn.initializers.lecun_normal`` truncates them, zero
  biases, unit norm scales, PReLU 0.25) and ``optax.adamw`` by default;
- :func:`make_train_step` and :func:`make_eval_step`.

A train step normalises with the batch's statistics and writes the new
running statistics after the forward (Flax's ``mutable=["batch_stats"]``),
draws ENet's dropout masks before the forward, and with ``remat=True``
recomputes the forward in the backward (``torch.utils.checkpoint``) with
the same masks and the same statistics.  With a ``mesh``
(``parallel/mesh.py``) the step equals the single-process step over the
whole batch: BatchNorm sums, the loss's numerator and denominator and the
gradients are summed over the mesh's batch axes, and the masks are drawn
for the global batch.  A "data" axis splits the samples
(``parallel.shard_batch``); a "space" axis splits their rows
(``parallel.shard_batch_spatial``), and the model exchanges halos over
it during the step (``parallel/halo.py``); a "model" axis holds the
model's channel-wide leaves sliced (``parallel.shard_params_tp``).
Unlike the JAX step, it updates the state in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..models.enet import ConvTranspose
from ..models.layers import BatchNorm
from ..models.unet import UpConv2x
from .optim import AdamW, AdamWState

# Flax's lecun_normal: a normal truncated at 2 sigma, widened by this
# factor so that the truncated distribution keeps variance 1 / fan_in.
TRUNC_STD = 0.87962566103423978


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                        class_weights: Optional[torch.Tensor] = None,
                        ignore_label: int = 255
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(nll * w), sum(w)) of :func:`softmax_cross_entropy`, in f32
    (f64 for f64 logits, so that a float64 step is float64 throughout).

    A pixel counts with weight ``w`` = 1 (or its class's weight) when its
    label is a class, 0 when it is ``ignore_label`` or out of range.  The
    picked logit is a gather; the JAX package's one-hot sum adds it to
    zeros, so both give the same value."""
    num_classes = logits.shape[-1]
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    valid = (labels != ignore_label) & (labels < num_classes)
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, safe[..., None])[..., 0]
    w = valid.to(lf.dtype)
    if class_weights is not None:
        w = w * class_weights.to(lf.device, lf.dtype)[safe]
    return ((lse - picked) * w).sum(), w.sum()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: Optional[torch.Tensor] = None,
                          ignore_label: int = 255) -> torch.Tensor:
    """Mean weighted CE over (..., C) logits and integer labels; pixels
    labelled ``ignore_label`` contribute nothing."""
    num, den = cross_entropy_terms(logits, labels, class_weights,
                                   ignore_label)
    return num / den.clamp_min(1.0)


@dataclasses.dataclass
class TrainState:
    """A model in training: ``model`` holds the parameters (f32) and the
    BatchNorm running statistics, ``tx``/``opt_state`` the optimizer, and
    ``step`` the updates made."""

    model: nn.Module
    tx: AdamW
    opt_state: AdamWState
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        params = self.params
        return {k: v for k, v in self.model.state_dict().items()
                if k not in params}


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's initial values, drawn on the CPU from ``generator`` in
    parameter order: kernels LeCun-normal (truncated), biases 0, norm
    scales 1, PReLU slopes 0.25, running mean 0 and variance 1."""
    transposed = {id(m.weight) for m in model.modules()
                  if isinstance(m, (ConvTranspose, UpConv2x))}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            shape = p.shape
            fan_in = (shape[0] * math.prod(shape[2:]) if id(p) in transposed
                      else math.prod(shape[1:]))
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            w = torch.empty(shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            p.copy_(w)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "alpha":
            p.fill_(0.25)
        else:
            p.zero_()
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.mean.zero_()
            mod.var.fill_(1.0)
    refresh(model)


def refresh(model: nn.Module) -> None:
    """Remake what a model derives from its weights for serving (ENet's
    folded BatchNorms, SegFormer's folded head and int8 weights), after
    the weights changed."""
    for derive in ("fold", "clear"):
        fn = getattr(model, derive, None)
        if fn is not None:
            fn()


def create_train_state(model: nn.Module,
                       input_shape: Tuple[int, int, int, int],
                       optimizer: Optional[AdamW] = None,
                       learning_rate: float = 1e-3,
                       seed: int = 0, device="cuda") -> TrainState:
    """Initialise ``model`` from ``seed`` (:func:`init_parameters`), move it
    to ``device``, run it once on zeros of ``input_shape`` (N, H, W, 3) as
    Flax's ``init`` does (a shape the model refuses raises here), and wrap
    it with ``optimizer`` (default ``AdamW(learning_rate)``)."""
    if optimizer is None:
        optimizer = AdamW(learning_rate)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device).eval()
    with torch.no_grad():
        model(torch.zeros(input_shape, device=device))
    model.train()
    return TrainState(model, optimizer,
                      optimizer.init(dict(model.named_parameters())))


def make_train_step(model: nn.Module,
                    class_weights: Optional[np.ndarray] = None,
                    ignore_label: int = 255, remat: bool = False,
                    mesh=None) -> Callable:
    """The train step: ``step(state, images, labels, rng=None,
    dropout=None) -> (state, loss)``.

    ``images`` (N, H, W, 3) in the compute dtype and ``labels`` (N, H, W)
    integers, on the model's device (with a ``mesh``, this rank's shard
    of the global batch, ``shard_batch``).  ENet draws its dropout masks
    for the global batch from ``rng`` (a ``torch.Generator``, in the same
    state on every rank) unless ``dropout`` gives them (name → (N_global,
    C)).  ``loss`` is the global batch's, a 0-d tensor on the device.

    ``remat=True`` checkpoints the forward (``torch.utils.checkpoint``):
    the backward recomputes it, with the same masks and statistics, so the
    step's result is the plain step's.  ``mesh``: parallel over its axes
    (module docstring); the masks are drawn for the samples of every
    "data" rank, and a rank takes its samples' masks.
    """
    from ..parallel.halo import RowShards, install_rows

    cw = (None if class_weights is None
          else torch.as_tensor(np.asarray(class_weights), dtype=torch.float32))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    draw = getattr(model, "dropout_masks", None)
    rank, world = ((0, 1) if mesh is None
                   else (mesh.index("data"), mesh.size("data")))
    rows = (None if mesh is None or mesh.size("space") == 1 else
            RowShards(mesh.group("space"), mesh.size("space"),
                      mesh.index("space"), mesh.device))

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   rng: Optional[torch.Generator] = None,
                   dropout: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than the one "
                             "this step was made for")
        model.train()
        n = images.shape[0]
        kwargs = {}
        if draw is not None:
            if dropout is None:
                if rng is None:
                    raise ValueError("this model draws dropout masks: pass "
                                     "rng (a torch.Generator) or dropout")
                dropout = draw(rng, n * world)
            kwargs["dropout"] = {
                k: v[rank * n:(rank + 1) * n].to(images.device)
                for k, v in dropout.items()}
        for bn in bns:
            bn.sync = None if mesh is None else mesh.sum_moments
        params = state.params
        for p in params.values():
            p.grad = None

        def forward(x):
            return model(x, **kwargs)

        if rows is not None:
            install_rows(model, rows)
        try:
            logits = (checkpoint(forward, images, use_reentrant=False)
                      if remat else forward(images))
            new_stats = [bn.running_update() for bn in bns]
            num, den = cross_entropy_terms(logits, labels, cw, ignore_label)
            num_all = num.detach()
            if mesh is not None:
                num_all, den = mesh.all_reduce(num_all), mesh.all_reduce(den)
            total = den.clamp_min(1.0)
            (num / total).backward()
        finally:
            if rows is not None:
                install_rows(model, None)
        if mesh is not None:
            mesh.all_reduce_grads(list(params.values()))
        with torch.no_grad():
            for bn, (mean, var) in zip(bns, new_stats):
                bn.mean.copy_(mean)
                bn.var.copy_(var)
        state.tx.step(params, state.opt_state)
        state.step += 1
        return state, num_all / total

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    """``eval_step(state, images) -> logits``: eval mode from the running
    statistics, after :func:`refresh` (ENet's folds follow the trained
    weights)."""

    @torch.no_grad()
    def eval_step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        refresh(state.model)
        return state.model(images)

    return eval_step


__all__ = ["TrainState", "create_train_state", "init_parameters",
           "refresh", "softmax_cross_entropy", "cross_entropy_terms",
           "make_train_step", "make_eval_step"]
