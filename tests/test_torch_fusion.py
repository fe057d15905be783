"""The port's temporal grid fusion (``fusion.py``) against the JAX
package's, exact: ``fuse_step`` and ``translate_state`` on the same states
and grids (odds bit for bit, fused grids and observed masks equal), and
``TemporalGridFusion`` over a 20-frame sequence with ego-motion (whole and
fractional cells, both signs, a reset halfway), the port's ``"numpy"``
backend against the JAX ``"numpy"`` one and the port's ``"torch"``
backend (on the CPU here; on the card in tests/test_torch_cuda.py)
against the JAX ``"jax"`` one.  The fused grids are equal everywhere.  The
odds are bit-equal to the JAX package's numpy backend and to its eager
``fuse_step``; its jitted ``"jax"`` backend contracts ``decay * odds +
obs`` into one fused multiply-add on the CPU, so its odds drift from its
own numpy backend's by an ulp a step (9.5e-7 on 35 % of the cells after
the sequence), and the port's odds (which, like numpy, round the product
first, on the card too) sit exactly where the JAX numpy backend's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import fusion as jf
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import fusion as pf

SHAPE = (40, 60)
FRAMES = 20
CELL_M = 0.1


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sequence(seed=0):
    """Grids in {-1, 0, 100} with a persistent obstacle block and an
    unseen band, and per-frame motion (forward, left) in metres."""
    rng = np.random.default_rng(seed)
    grids, motion = [], []
    for t in range(FRAMES):
        g = rng.choice(np.array([-1, 0, 100], np.int8), SHAPE,
                       p=[0.2, 0.6, 0.2])
        g[5:12, 20:30] = 100
        g[:, :4] = -1
        grids.append(g)
        motion.append((float(rng.uniform(0.0, 0.25)),
                       float(rng.uniform(-0.17, 0.17))))
    return grids, motion


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_fuse_step_bit_equal():
    grids, _ = _sequence(1)
    js = jf.FusionState.create(SHAPE)
    ps = pf.FusionState.create(SHAPE, device="cpu")
    kw = dict(decay=0.8, step=1.5, max_odds=4.0, occupied_threshold=1.2,
              free_threshold=0.5)
    for g in grids:
        js, jfused = jf.fuse_step(js, jnp.asarray(g), **kw)
        ps, pfused = port.fuse_step(ps, torch.from_numpy(g), **kw)
        np.testing.assert_array_equal(_np(pfused), np.asarray(jfused))
        np.testing.assert_array_equal(_np(ps.odds), np.asarray(js.odds))
        np.testing.assert_array_equal(_np(ps.observed),
                                      np.asarray(js.observed))
    assert pfused.dtype == torch.int8
    assert {-1, 0, 100} == set(np.unique(_np(pfused)).tolist())


@pytest.mark.parametrize("dy,dx", [(0, 0), (2, -3), (-1, 5), (45, 0),
                                   (0, -61), (3, 3)])
def test_translate_state_bit_equal(dy, dx):
    rng = np.random.default_rng(abs(dy * 100 + dx))
    odds = rng.standard_normal(SHAPE).astype(np.float32)
    observed = rng.random(SHAPE) < 0.5
    j = jf.translate_state(jf.FusionState(jnp.asarray(odds),
                                          jnp.asarray(observed)), dy, dx)
    p = pf.translate_state(pf.FusionState(torch.from_numpy(odds),
                                          torch.from_numpy(observed)),
                           dy, dx)
    np.testing.assert_array_equal(_np(p.odds), np.asarray(j.odds))
    np.testing.assert_array_equal(_np(p.observed), np.asarray(j.observed))
    o, ob = pf._translate_np(odds, observed, dy, dx)
    np.testing.assert_array_equal(o, np.asarray(j.odds))
    np.testing.assert_array_equal(ob, np.asarray(j.observed))
    assert o.dtype == np.float32


@pytest.mark.parametrize("backend,jax_backend", [("numpy", "numpy"),
                                                 ("torch", "jax")])
def test_temporal_fusion_sequence_exact(backend, jax_backend):
    grids, motion = _sequence(2)
    jt = jf.TemporalGridFusion(SHAPE, backend=jax_backend, cell_m=CELL_M)
    pt = port.TemporalGridFusion(SHAPE, backend=backend, cell_m=CELL_M,
                                 device="cpu")
    for t, (g, m) in enumerate(zip(grids, motion)):
        if t == FRAMES // 2:
            jt.reset()
            pt.reset()
        want = np.asarray(jt.update(g, motion_m=m))
        got = pt.update(torch.from_numpy(g) if backend == "torch" else g,
                        motion_m=m)
        if backend == "torch":
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(pt._residual, jt._residual)
    odds = _np(pt.state.odds) if backend == "torch" else pt._odds
    if jax_backend == "numpy":
        np.testing.assert_array_equal(odds, jt._odds)
    else:
        # the JAX numpy backend over the same sequence: the port's odds
        # are its odds, and the jitted backend's sit as far from both
        jn = jf.TemporalGridFusion(SHAPE, cell_m=CELL_M)
        for t, (g, m) in enumerate(zip(grids, motion)):
            if t == FRAMES // 2:
                jn.reset()
            jn.update(g, motion_m=m)
        np.testing.assert_array_equal(odds, jn._odds)
        assert np.abs(odds - np.asarray(jt.state.odds)).max() <= 1e-6
    assert {-1, 0, 100} == set(np.unique(want).tolist())


def test_torch_and_numpy_backends_equal():
    """The port's two backends: the same grids and the same odds, bit for
    bit, over the sequence (the JAX package's two differ by an ulp in the
    odds, see the module docstring)."""
    grids, motion = _sequence(3)
    a = port.TemporalGridFusion(SHAPE, backend="torch", cell_m=CELL_M,
                                device="cpu")
    b = port.TemporalGridFusion(SHAPE, cell_m=CELL_M)
    for g, m in zip(grids, motion):
        np.testing.assert_array_equal(
            a.update(torch.from_numpy(g), motion_m=m).numpy(),
            b.update(g, motion_m=m))
    np.testing.assert_array_equal(a.state.odds.numpy(), b._odds)
    np.testing.assert_array_equal(a.state.observed.numpy(), b._observed)


def test_sequence_moves_in_whole_cells_both_ways():
    """The motion of the sequence shifts the evidence by whole cells on
    several frames, forward and both sideways."""
    _, motion = _sequence(2)
    res, moves = np.zeros(2), []
    for m in motion:
        res += np.array(m) / CELL_M
        whole = np.trunc(res)
        res -= whole
        moves.append(whole)
    moves = np.array(moves)
    assert (moves[:, 0] > 0).sum() >= 5
    assert (moves[:, 1] > 0).any() and (moves[:, 1] < 0).any()


def test_fusion_semantics():
    """One glitch frame does not make a cell occupied; two do; cells that
    left the view decay to unknown, not free; unseen cells stay -1."""
    f = port.TemporalGridFusion((1, 3), device="cpu")
    occ = np.array([[100, 0, -1]], np.int8)
    assert f.update(occ).tolist() == [[-1, 0, -1]]
    assert f.update(occ).tolist() == [[100, 0, -1]]
    gone = np.full((1, 3), -1, np.int8)
    for _ in range(30):
        last = f.update(gone)
    assert last.tolist() == [[-1, -1, -1]]
    with pytest.raises(ValueError, match="backend"):
        port.TemporalGridFusion((2, 2), backend="jax")
