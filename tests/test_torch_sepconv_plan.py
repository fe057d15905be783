"""The launch plan of the fused separable conv (``ops/cuda/sepconv.plan``).

The plan -- pixel tile, thread block cluster size G, weight ring depth --
is computed in the wrapper and checked by the kernel, which runs only on
the card.  Here, on the CPU: for every site shape chip_smoke.py holds (the
Xception path at 1024x512 and the two stride-2 extras) and for C in {8, 24,
1536}, the plan does not depend on the batch, its cluster divides the
grid's cluster dimension, its channel slices partition C, its F tiles cover
F, its shared memory fits a CTA; ``launch_args`` passes it to the C
launcher; shapes the kernel does not take raise ValueError.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (H, W, C, F, stride)
SHAPES = ([(h, w, c, f, s) for _, h, w, c, f, s, _, _ in chip_smoke.SEP_SITES]
          + [(16, 32, 8, 16, 1), (16, 32, 8, 16, 2), (9, 13, 24, 40, 1),
             (16, 32, 24, 40, 2), (16, 32, 1536, 1536, 1),
             (16, 32, 1536, 728, 2)])
IDS = ["x".join(map(str, s)) for s in SHAPES]
SMEM_LIMIT = 232448     # dynamic shared memory of one CTA on an H100


def _cpu_launch_args(monkeypatch, n, h, w, c, f, stride, dtype):
    """launch_args on CPU tensors, the device check and stream replaced."""
    monkeypatch.setattr(sc, "_CARD", "cpu")
    monkeypatch.setattr(sc, "_stream", lambda dev: 0)
    x = torch.zeros(n, h, w, c, dtype=dtype)
    out = torch.zeros(n, h // stride, w // stride, f, dtype=dtype)
    vec = (lambda k: torch.zeros(k))
    return sc.launch_args(x, out, torch.zeros(3, 3, 1, c), vec(c), vec(c),
                          torch.zeros(c, f, dtype=dtype), vec(f), vec(f),
                          strides=stride, act_out=True)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_is_whole_and_fits(shape):
    h, w, c, f, stride = shape
    pl = sc.plan(h, w, c, f, stride)
    assert pl.tile_rows in (4, 8) and pl.tile_cols == 8
    assert pl.tiles_h == -(-(h // stride) // pl.tile_rows)
    assert pl.tiles_w == -(-(w // stride) // 8)
    # a cluster of at most 8 CTAs that divides the grid's cluster dimension
    assert 1 <= pl.cluster <= 8
    for n in (1, 4):
        gx, gy, gz = pl.grid(n)
        assert gx % pl.cluster == 0 and gx // pl.cluster == pl.tiles_w
        assert (gy, gz) == (pl.tiles_h, n)
    # channel slices partition C in whole groups of 8, none empty
    assert len(pl.channel_slices) == pl.cluster
    assert pl.channel_slices[0][0] == 0 and pl.channel_slices[-1][1] == c
    for (lo, hi), (nlo, _) in zip(pl.channel_slices, pl.channel_slices[1:]):
        assert hi == nlo
    assert all(lo < hi and lo % 8 == 0 for lo, hi in pl.channel_slices)
    # F tiles of 64 cover F, each CTA at least one
    nft = -(-f // 64)
    assert pl.f_tiles[0][0] == 0 and pl.f_tiles[-1][1] == nft
    for (lo, hi), (nlo, _) in zip(pl.f_tiles, pl.f_tiles[1:]):
        assert hi == nlo
    assert all(lo < hi for lo, hi in pl.f_tiles)
    # ring, window and the full y1 in one CTA's shared memory
    assert 2 <= pl.stages <= 4
    assert pl.smem_bytes == sc.smem_bytes(pl.tile_rows, c, stride, pl.stages)
    assert pl.smem_bytes <= SMEM_LIMIT
    y1 = pl.tile_rows * 8 * -(-c // 64) * 64 * 2
    assert pl.smem_bytes > y1 + pl.stages * 64 * 128 * 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_launch_args_pass_the_plan_for_any_batch(monkeypatch, shape, dtype):
    """The same plan for one frame and for four, passed through as the C
    launcher's tile_rows, cluster and stages."""
    h, w, c, f, stride = shape
    pl = sc.plan(h, w, c, f, stride)
    tails = []
    for n in (1, 4):
        args = _cpu_launch_args(monkeypatch, n, h, w, c, f, stride, dtype)
        assert len(args) == 20 and args[8:14] == (n, h, w, c, f, stride)
        assert args[15] == int(dtype == torch.bfloat16)
        tails.append(args[16:19])
    assert tails[0] == tails[1] == (pl.tile_rows, pl.cluster, pl.stages)


def test_path_plans_as_measured():
    """The plans of the path's busiest sites, as chosen on an H100 (PERF.md,
    scripts/torch_sepconv_split.py): the middle flow's 32 tiles share each
    tile among a cluster of 3 (39 such clusters fit the card at once, 32
    of 4 do not); block 3's 128 tiles run one CTA each."""
    assert (lambda p: (p.tile_rows, p.cluster, p.stages))(
        sc.plan(32, 64, 728, 728, 1)) == (8, 3, 4)
    assert sc.plan(64, 128, 728, 728, 1).cluster == 1
    assert sc.plan(256, 512, 64, 128, 1).cluster == 1


@pytest.mark.parametrize("bad", [(16, 32, 8, 16, 3), (15, 32, 8, 16, 2),
                                 (16, 31, 8, 16, 2), (16, 32, 4000, 16, 1),
                                 (16, 32, 0, 16, 1), (16, 32, 8, 0, 1)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        sc.plan(*bad)


def test_launch_args_refuse_a_huge_batch(monkeypatch):
    with pytest.raises(ValueError, match="65535"):
        _cpu_launch_args(monkeypatch, 65536, 2, 2, 8, 8, 1, torch.bfloat16)
