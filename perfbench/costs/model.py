"""The model's FLOPs per grid: every product (convolutions, matrix
products, attention) of one frame through the configuration's plain
reference, counted by ``torch.utils.flop_counter`` on shapes alone (the
meta device: nothing is computed)."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import reference
from perfbench.reference.common import Precision


def flops_per_grid(cfg: dict) -> float:
    module = reference.model_module(cfg["reference"])
    w = {k: torch.empty(s, device="meta")
         for k, s in module.layout(cfg)}
    x = torch.empty((1, cfg["input_height"], cfg["input_width"], 3),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        module.Model(w, cfg, Precision("f32"))(x)
    return float(counter.get_total_flops())

