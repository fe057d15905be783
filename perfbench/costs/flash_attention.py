"""Operations and bytes of the attention kernel (``ops.cuda.attention``,
both layouts) at SegFormer's shapes.

SegFormer runs its backbone one frame at a time, so a launch is one
frame's block: H heads of d channels, Nq query tokens of the stage's map
and Nkv = Nq / sr² reduced key tokens.  FLOPs: q·kᵀ and p·v, 2·Nq·Nkv·d
each per head.  Bytes: q, k, v read once and the output written once,
in the configuration's activation dtype.
"""

from typing import List, Tuple

MATCH = "flash_attention"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def launches(cfg: dict, batch: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each launch of one engine call on ``batch``
    frames, in launch order."""
    m = cfg["model"]
    size = ITEMSIZE[cfg["dtype"]]
    h, w = cfg["input_height"], cfg["input_width"]
    one = []
    for s, width in enumerate(m["widths"]):
        stride = 4 * 2 ** s
        nq = (h // stride) * (w // stride)
        nkv = nq // (m["sr_ratios"][s] ** 2)
        heads = m["num_heads"][s]
        d = width // heads
        flops = 4.0 * heads * nq * nkv * d
        nbytes = float(size * heads * d * (2 * nq + 2 * nkv))
        one += [(flops, nbytes)] * m["depths"][s]
    return one * batch
