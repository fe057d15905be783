"""Multi-device training on ``torch.distributed``.

Port of ``bugcar_image_segmentation_tpu/parallel/``'s data-parallel part
(``mesh.py``): :func:`make_mesh` (the process group), :func:`shard_batch`
(this rank's slice of a global batch), :func:`replicate` (rank 0's values
on every rank), and :class:`Mesh`, which a train step takes to be data
parallel (``training/trainer.make_train_step(..., mesh=)``).  The JAX
package's tensor-parallel, spatial and camera-sharded modules are not
ported yet.
"""

from .mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch"]
