"""Multi-device serving and training on ``torch.distributed``.

Port of ``bugcar_image_segmentation_tpu/parallel/``.  The JAX package
expresses parallelism as named meshes and sharding annotations and lets
XLA insert the collectives; here each rank is one process with one device
and the port makes the collectives itself, scoped to a mesh axis:

- :mod:`~.mesh` — :func:`make_mesh` (named axes, one process group per
  axis line), :func:`shard_batch`, :func:`replicate`, and :class:`Mesh`,
  which a train step takes to be parallel
  (``training/trainer.make_train_step(..., mesh=)``)
- :mod:`~.multicam` — the camera rig sharded over ranks, grids merged by a
  max all-reduce
- :mod:`~.tp` — channel-sharded (tensor-parallel) serving and dp x tp
  training
- :mod:`~.spatial` — one frame's rows over ranks (``halo.py``: the halo
  exchanges), for single-frame serving and dp x sp training; sharded
  artifacts (``deploy.Deployed.call_sharded``)
"""

from .halo import RowShards
from .mesh import Mesh, make_mesh, replicate, shard_batch
from .multicam import ShardedMultiCameraPipeline
from .spatial import shard_batch_spatial, shard_engine_spatial
from .tp import shard_engine_tp, shard_params_tp, tp_spec_for

__all__ = [
    "Mesh", "make_mesh", "replicate", "shard_batch", "RowShards",
    "ShardedMultiCameraPipeline", "shard_batch_spatial",
    "shard_engine_spatial", "shard_engine_tp", "shard_params_tp",
    "tp_spec_for",
]
