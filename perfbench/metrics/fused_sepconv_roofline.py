"""The separable-conv kernel's share of its roofline (``roofline.py``)."""

from perfbench.roofline import share


def read(ctx, name):
    return share(ctx, "fused_sepconv")
