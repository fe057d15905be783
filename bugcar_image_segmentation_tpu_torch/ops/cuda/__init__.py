"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
a wrapper that launches it on CUDA tensors and its plain PyTorch version,
which runs on CPU tensors.

``LAUNCHES`` counts, per kernel, the launches made; a run sets the counts
to 0 (:func:`reset_launches`) and reads them afterwards to show that a path
went through the kernels.  The four serving kernels count inside the CUDA
implementation of their ``torch.library`` op (``library.py``), so a loaded
``torch.export`` artifact counts too; the probes count in their wrappers,
and ``ROUTES`` counts the probes' launches again by route (``tma`` or
``simt``, ``probes.tma_refusal``).  A CUDA graph's replay adds the counts
its capture made (:func:`add_launches`), since its kernels run again.
Every rise of a kernel's count goes through :func:`counted`, which also
adds it to the span recorder's counter ``launches.<kernel>`` while the
recorder records (``utils/profiling.py``): the count of a traced window,
replays included.  Importing this package registers those ops.
"""

from ...utils.profiling import count

LAUNCHES = {"fused_bottleneck": 0, "flash_attention": 0,
            "flash_attention_t": 0, "fused_sepconv": 0,
            "strided_gather": 0, "strided_gather_bf16": 0, "halo_add": 0}
ROUTES = {name: {"tma": 0, "simt": 0}
          for name in ("strided_gather", "strided_gather_bf16", "halo_add")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


def launch_counts() -> dict:
    """``LAUNCHES`` and ``ROUTES`` now, flat: {(kernel,): n, (kernel,
    route): n}."""
    flat = {(name,): n for name, n in LAUNCHES.items()}
    flat.update({(name, route): n for name, counts in ROUTES.items()
                 for route, n in counts.items()})
    return flat


def counted(kernel: str, n: int = 1) -> None:
    """Count ``n`` launches of ``kernel``: in ``LAUNCHES`` and, while
    recording, in the counter ``launches.<kernel>``."""
    LAUNCHES[kernel] += n
    count("launches." + kernel, n)


def add_launches(delta: dict) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`) to the counts: a
    CUDA graph's replay launches again what its capture counted."""
    for key, n in delta.items():
        if len(key) == 1:
            counted(key[0], n)
        else:
            ROUTES[key[0]][key[1]] += n


from . import library  # noqa: E402,F401  (registers the bugcar ops)
