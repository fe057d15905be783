"""Write and load Flax msgpack checkpoints and their config sidecar,
without Flax; save and restore a train state to resume training.

Port of ``bugcar_image_segmentation_tpu/utils/checkpoint.py``.  A
checkpoint is a msgpack-serialized Flax variable tree (``{"params": ...,
"batch_stats": ...}``) and, beside it, ``<path>.config.json`` with the
model config.  :func:`load_variables` returns the tree with numpy leaves
(``bfloat16`` leaves widened to float32 with the same values, see
``utils/msgpack.py``), the form that the weight bridges in ``convert/``
and ``build_engine(..., variables=...)`` take; :func:`save_variables`
writes the bytes Flax writes, so the JAX package loads a checkpoint the
port trained (``convert/flax_tree.flax_variables`` makes the tree).

:func:`save_train_state` / :func:`restore_train_state` keep what resuming
needs beyond the weights (optimizer moments, step) with ``torch.save``.
The JAX package keeps a train state with Orbax; the two formats are not
interchangeable (a Flax checkpoint carries the weights across).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Tuple

import torch

from ..configs import ModelConfig
from . import msgpack

SIDECAR = ".config.json"


def save_variables(path: str, variables: Mapping,
                   cfg: Optional[ModelConfig] = None) -> None:
    """Write a Flax variable tree (numpy or tensor leaves) as
    ``flax.serialization.msgpack_serialize`` does, and the config sidecar
    as the JAX package writes it."""
    with open(path, "wb") as f:
        f.write(msgpack.serialize(dict(variables)))
    if cfg is not None:
        with open(path + SIDECAR, "w") as f:
            json.dump(dataclasses.asdict(cfg), f)


def load_variables(path: str) -> Tuple[dict, Optional[ModelConfig]]:
    """(variable tree, ModelConfig from the sidecar or None)."""
    with open(path, "rb") as f:
        variables = msgpack.restore(f.read())
    cfg = None
    if os.path.exists(path + SIDECAR):
        with open(path + SIDECAR) as f:
            raw = json.load(f)
        raw["image_mean"] = tuple(raw.get("image_mean", ()))
        raw["image_std"] = tuple(raw.get("image_std", ()))
        cfg = ModelConfig(**raw)
    return variables, cfg


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.pt")


def save_train_state(directory: str, state, step: Optional[int] = None
                     ) -> str:
    """Save a ``training.TrainState`` (its model's state dict, the AdamW
    moments and count, the step) as ``<directory>/step_<step>.pt``;
    returns the path."""
    step = state.step if step is None else step
    os.makedirs(directory, exist_ok=True)
    path = _step_path(directory, step)
    torch.save({"model": state.model.state_dict(),
                "mu": state.opt_state.mu, "nu": state.opt_state.nu,
                "count": state.opt_state.count, "step": state.step}, path)
    return path


@torch.no_grad()
def restore_train_state(directory: str, template, step: int):
    """Load :func:`save_train_state`'s file into ``template`` (a
    TrainState of the same model and optimizer, on any device) in place;
    returns it."""
    saved = torch.load(_step_path(directory, step), map_location="cpu",
                       weights_only=True)
    template.model.load_state_dict(saved["model"])
    for name in ("mu", "nu"):
        moments = getattr(template.opt_state, name)
        if set(moments) != set(saved[name]):
            raise ValueError(f"the saved {name} does not match the "
                             f"template's parameters")
        for k, t in moments.items():
            t.copy_(saved[name][k])
    template.opt_state.count = int(saved["count"])
    template.step = int(saved["step"])
    return template


__all__ = ["load_variables", "save_variables", "save_train_state",
           "restore_train_state", "SIDECAR"]
