"""The attention kernel's share of its roofline, both layouts
(``roofline.py``)."""

from perfbench.roofline import share


def read(ctx, name):
    return share(ctx, "flash_attention")
