"""The card's published peaks and what ``nvidia-smi`` reads of it.

Peaks from NVIDIA's H100 SXM data sheet, dense (no sparsity), at the
full 700 W power limit: 989 TFLOP/s in bfloat16 on the tensor cores and
3.35 TB/s of HBM3.  A card set below 700 W runs slower under load; its
``power.limit`` is reported beside every share of these peaks.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional

BF16_FLOP_S = 989e12
HBM_BYTE_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / BF16_FLOP_S, nbytes / HBM_BYTE_S)


def bound(flops: float, nbytes: float) -> str:
    return "flops" if flops / BF16_FLOP_S >= nbytes / HBM_BYTE_S else "bytes"


def card() -> Dict[str, Optional[object]]:
    """The card's name and power limit in watts (None where nvidia-smi
    does not say)."""
    import torch

    out: Dict[str, Optional[object]] = {
        "name": torch.cuda.get_device_name(0), "power_limit_w": None}
    smi = shutil.which("nvidia-smi")
    if smi:
        try:
            line = subprocess.run(
                [smi, "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=20).stdout.strip()
            out["power_limit_w"] = float(line.splitlines()[0])
        except (subprocess.SubprocessError, ValueError, IndexError):
            pass
    return out
