"""The port's camera-sharded rig (``parallel/multicam.py``) in gloo
processes on the CPU, against the one-process rig of the port and the JAX
package's ``MultiCameraPipeline`` (the unsharded JAX program; the JAX
package's own sharded test, tests/test_parallel.py, holds its sharded rig
equal to that).

8 cameras of ENet in f32 at 32x64 (96x48 frames, resized on the device),
sharded over 2 and over 4 ranks: every rank's stitched grid equals both,
bit for bit.  The ``enet_fused`` engine (the ``fused_bottleneck``
kernel's plain version on the CPU) over 2 ranks gives the same grid too.
Cameras that do not divide over the axis are refused, with the JAX
package's message.
"""

import os

import numpy as np
import pytest
import torch

import torch_gloo
from torch_gloo import one_thread  # noqa: F401

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from bugcar_image_segmentation_tpu.configs import (
        CalibrationConfig as JCal, GridConfig as JGrid, ModelConfig as JModel)
    from bugcar_image_segmentation_tpu.models.api import \
        build_engine as jbuild
    from bugcar_image_segmentation_tpu.pipeline import \
        MultiCameraPipeline as JRig

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.parallel import (
    Mesh, ShardedMultiCameraPipeline, make_mesh)

HW = (32, 64)
FRAME_HW = (48, 96)
GRID = (4.0, 4.0, 0.2)
N_CAM = 8
SEED = 21


def cameras():
    return [toy_calibration(HW, yaw=0.1 * i - 0.4) for i in range(N_CAM)]


def frames():
    rng = np.random.default_rng(4)
    return rng.integers(0, 256, (N_CAM,) + FRAME_HW + (3,), np.uint8)


def engine(name: str = "enet"):
    cfg = port.ModelConfig(name=name, input_width=HW[1], input_height=HW[0],
                           dtype="float32")
    return port.build_engine(name, cfg, variables=random_enet_variables(SEED),
                             device="cpu")


def worker(mesh_args: dict, folder: str, case: str) -> None:
    """One rank: the sharded rig's grid for ``case`` ("enet" or
    "enet_fused")."""
    mesh = make_mesh(**mesh_args)
    try:
        rig = ShardedMultiCameraPipeline(engine(case), cameras(),
                                         port.GridConfig(*GRID), mesh)
        grid = rig(frames()).numpy()
        np.save(os.path.join(folder, f"{case}_rank{mesh.rank}.npy"), grid)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def want():
    """The port's one-process rig grid and the JAX rig's."""
    cals = cameras()
    x = frames()
    local = port.MultiCameraPipeline(engine(), cals, port.GridConfig(*GRID))
    jeng = jbuild("enet", JModel(name="enet", input_width=HW[1],
                                 input_height=HW[0], dtype="float32"),
                  variables=jax.tree_util.tree_map(
                      jnp.asarray, random_enet_variables(SEED)))
    jcals = [JCal.from_reference_dict(c.to_reference_dict()) for c in cals]
    jgrid = np.asarray(JRig(jeng, jcals, JGrid(*GRID))(x))
    return local(x).numpy(), jgrid


@pytest.mark.parametrize("world,case", [(2, "enet"), (4, "enet"),
                                        (2, "enet_fused")])
def test_sharded_rig_equals_one_process_and_jax(tmp_path, want, world, case):
    torch_gloo.run_ranks(__file__, str(tmp_path), (world, case))
    local, jgrid = want
    assert np.array_equal(local, jgrid)
    for rank in range(world):
        got = np.load(os.path.join(tmp_path, f"{case}_rank{rank}.npy"))
        assert got.dtype == np.int8 and got.shape == jgrid.shape
        assert np.array_equal(got, jgrid), (rank, (got != jgrid).sum())


def test_rejects_indivisible_cameras():
    mesh = Mesh(rank=0, world_size=4, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="6 cameras do not divide over 4"):
        ShardedMultiCameraPipeline(engine(), cameras()[:6],
                                   port.GridConfig(*GRID), mesh)


if __name__ == "__main__":
    torch_gloo.main(worker)
