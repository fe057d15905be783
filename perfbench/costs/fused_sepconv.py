"""Operations and bytes of the separable-conv kernel (``ops.cuda.sepconv``,
``sepconv_bf16``) at Xception's shapes.

The kernel serves the dilation-1 separable convs of the entry and middle
flows: those at stride 1, and at stride 2 where the input has 128
channels (the first block's last), as the program's gate decides.  One
launch takes the whole batch of an engine call.  A launch on C input and
F output channels with an H' x W' output per frame: FLOPs 2·(9·C + C·F)
a pixel (the 3x3 depthwise at the output pixels and the pointwise).
Bytes: x read once and y written once in the activation dtype, the f32
depthwise taps and the four folded f32 scale and bias vectors, and the
pointwise weights in the activation dtype, each read once.
"""

from typing import List, Tuple

MATCH = "sepconv_bf16"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def sites(cfg: dict) -> List[Tuple[int, int, int, int, int]]:
    """(H, W, C, F, stride) of each kernel site in forward order: the
    input's rows, columns and channels, the output's channels, the
    stride."""
    m = cfg["model"]
    h, w = -(-cfg["input_height"] // 2), -(-cfg["input_width"] // 2)
    out, cin = [], m["stem"][-1]
    for f in m["entry_widths"]:
        for i, c in enumerate((cin, f, f)):
            stride = 2 if i == 2 else 1
            if stride == 1 or (c == 128 and h % 2 == 0 and w % 2 == 0):
                out.append((h, w, c, f, stride))
        h, w, cin = -(-h // 2), -(-w // 2), f
    out += [(h, w, cin, cin, 1)] * (3 * m["middle_blocks"])
    return out


def launches(cfg: dict, batch: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each launch of one engine call on ``batch``
    frames, in launch order."""
    size = ITEMSIZE[cfg["dtype"]]
    one = []
    for h, w, c, f, stride in sites(cfg):
        pixels = batch * -(-h // stride) * -(-w // stride)
        flops = 2.0 * (9 * c + c * f) * pixels
        nbytes = (size * (batch * h * w * c + pixels * f + c * f)
                  + 4 * (9 * c + 2 * c + 2 * f))
        one.append((flops, float(nbytes)))
    return one
