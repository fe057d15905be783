"""The control, the plain reference computed in fp8 in the program's
place, comes out not correct: at a tiny size here (against the tiny
cells' limits), and on the card at each cell's own size on three seeds
(``python -m pytest -p no:cacheprovider perfbench/tests -m cuda`` there).
"""

import pytest

from perfbench import readings


@pytest.mark.parametrize("cell", ["tiny_seg.live", "tiny_seg.stream"])
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_control_fails_at_a_tiny_size(tiny_root, cell, seed):
    r = readings.control(cell, seed, "cpu", tiny_root / "BENCHMARK.json")
    assert not r["correct"], r["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["segformer_b0_1024x2048.live",
                                  "segformer_b0_1024x2048.stream"])
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (8001, 8002, 8003):
        r = readings.control(cell, seed, "cuda")
        assert not r["correct"], (seed, r["numbers"])
