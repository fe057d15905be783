"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
a wrapper that launches it on CUDA tensors and its plain PyTorch version,
which runs on CPU tensors.

``LAUNCHES`` counts, per kernel, the launches made; a run sets the counts
to 0 (:func:`reset_launches`) and reads them afterwards to show that a path
went through the kernels.  The four serving kernels count inside the CUDA
implementation of their ``torch.library`` op (``library.py``), so a loaded
``torch.export`` artifact counts too; the probes count in their wrappers.
Importing this package registers those ops.
"""

LAUNCHES = {"fused_bottleneck": 0, "flash_attention": 0,
            "flash_attention_t": 0, "fused_sepconv": 0,
            "strided_gather": 0, "strided_gather_bf16": 0, "halo_add": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


from . import library  # noqa: E402,F401  (registers the bugcar ops)
