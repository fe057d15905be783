"""The benchmark of the PyTorch and CUDA port
(``bugcar_image_segmentation_tpu_torch``), driven by ``BENCHMARK.json``.

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``).  Configurations, traffic
mixes, metric readers, kernel costs and correctness limits are files
found by name (``manifest.py``); the plain references that judge the
program's grids are in ``reference/``.  Nothing here imports JAX or the
JAX package.
"""
