"""Load a Flax msgpack checkpoint and its config sidecar, without Flax.

Port of ``bugcar_image_segmentation_tpu/utils/checkpoint.py``
(``load_variables``).  A checkpoint is a msgpack-serialized Flax variable
tree (``{"params": ..., "batch_stats": ...}``) and, beside it,
``<path>.config.json`` with the model config.  The tree comes back with
numpy leaves (``bfloat16`` leaves widened to float32 with the same
values, see ``utils/msgpack.py``), the form that the weight bridges in
``convert/`` and ``build_engine(..., variables=...)`` take.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from ..configs import ModelConfig
from . import msgpack

SIDECAR = ".config.json"


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


__all__ = ["load_variables", "SIDECAR"]
