"""The plain references the benchmark judges the served grids by: float32
PyTorch with TF32 off, over the same raw weights and frames the program
was given, importing nothing of the program.

A configuration names its model's module here (``"reference"``); each
module has ``layout(cfg)`` (the served state-dict keys and shapes) and
``Model(weights, cfg, precision, calibrate=False)``."""

import importlib

from . import common, grid  # noqa: F401  (the shared pieces)


def model_module(name: str):
    return importlib.import_module(f"{__name__}.{name}")
