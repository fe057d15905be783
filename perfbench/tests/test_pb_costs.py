"""The operation and byte counters against hand counts at tiny shapes."""

import json

from perfbench import manifest, peaks
from perfbench.tests.conftest import HERE

SEG = json.loads((HERE / "data" / "tiny_seg.json").read_text())


def test_attention_counts():
    # 64x128: stage 0 is 16x32 = 512 queries, 512 / 8² = 8 keys, 1 head of 32
    got = manifest.cost("flash_attention").launches(
        dict(SEG, input_height=64, input_width=128), 2)
    assert len(got) == 2 * 8
    assert got[0] == (4.0 * 512 * 8 * 32, 2.0 * 32 * (2 * 512 + 2 * 8))
    # stage 3: 2x4 = 8 queries and keys, 8 heads of 32
    assert got[7] == (4.0 * 8 * 8 * 8 * 32, 2.0 * 8 * 32 * (2 * 8 + 2 * 8))
    assert got[8:] == got[:8]


def test_model_flops_count_every_product():
    m, (h, w) = SEG["model"], (SEG["input_height"], SEG["input_width"])
    total, cin = 0, 3
    for s, c in enumerate(m["widths"]):
        stride, k = 4 * 2 ** s, (7 if s == 0 else 3)
        n = (h // stride) * (w // stride)
        nkv = n // m["sr_ratios"][s] ** 2
        total += 2 * n * c * cin * k * k                 # patch embedding
        block = (2 * n * c * c * 2 + 2 * nkv * c * c * 2  # q, proj; k, v
                 + 4 * n * nkv * c                        # q kᵀ, p v
                 + 2 * n * c * 4 * c * 2 + 2 * n * 4 * c * 9)  # fc1, fc2, dw
        if m["sr_ratios"][s] > 1:
            block += 2 * nkv * c * c * m["sr_ratios"][s] ** 2
        total += m["depths"][s] * block
        total += 2 * n * c * m["decoder_dim"]            # linear_c
        cin = c
    q = (h // 4) * (w // 4)
    total += 2 * q * 4 * m["decoder_dim"] * m["decoder_dim"]   # fuse
    total += 2 * q * m["decoder_dim"] * SEG["num_classes"]     # classifier
    assert manifest.cost("model").flops_per_grid(SEG) == total


def test_least_time_takes_the_longer_bound():
    assert peaks.least_seconds(989e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0
    assert peaks.bound(1.0, 1e6) == "bytes"


class _Trace:
    def __init__(self, frames, calls, launches_us):
        self.frames, self.calls, self.launches_us = frames, calls, launches_us

    def matching(self, key):
        return self.launches_us


class _Ctx:
    def __init__(self, trace):
        from perfbench.tests.conftest import BENCH
        self.trace, self.cfg, self.base, self.notes = trace, SEG, BENCH, {}


def test_roofline_share_charges_each_launch_its_own_work():
    from perfbench import roofline
    per_call = manifest.cost("flash_attention").launches(SEG, 4)
    least = sum(peaks.least_seconds(f, b) for f, b in per_call)
    ctx = _Ctx(_Trace(12, 3, [10.0] * 3 * len(per_call)))   # 3 calls of 4
    got = roofline.share(ctx, "flash_attention")
    assert abs(got - 100.0 * 3 * least / (3 * len(per_call) * 10e-6)) < 1e-9
    bound = peaks.bound(*map(sum, zip(*per_call)))
    assert ctx.notes["flash_attention"] == {"bound": bound}


def test_roofline_share_is_left_out_when_the_launches_do_not_match():
    """A call split into more launches than the costs count (or frames
    run one by one) gives no share, and says why."""
    from perfbench import roofline
    n = 3 * len(manifest.cost("flash_attention").launches(SEG, 4))
    ctx = _Ctx(_Trace(12, 3, [5.0] * 2 * n))
    assert roofline.share(ctx, "flash_attention") is None
    assert ctx.notes["flash_attention"] == {"launches_traced": 2 * n,
                                            "launches_counted": n}
