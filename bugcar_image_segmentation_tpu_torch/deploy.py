"""Deployment artifacts: the frozen serving program, as ``torch.export``.

Port of ``bugcar_image_segmentation_tpu/deploy.py``, the role of the
reference's frozen graphs (``freeze_session`` and the shipped
``pretrained_models/*.pb``): bake the trained weights into the serving
program and write a self-contained artifact that loads and runs without
the model-building code.  Where the JAX package serialises ``jax.export``
StableHLO, the port serialises a ``torch.export`` program: the aten graph
of the engine, pipeline or rig with its weights, and the four serving
kernels as the ``bugcar::`` ops of ``ops/cuda/library.py``, so the
artifact launches the same hand-written kernels as the live program.

**What loading needs.** :func:`load_artifact` needs torch and the op
registrations (``ops.cuda``, which imports torch and builds nothing until
a CUDA op runs).  It imports none of the model code: ``models/``,
``convert/``, ``pipeline`` and ``grid`` stay unimported, as the JAX
artifact loads with jax alone.

The contract is the JAX package's:

- **Weights are a snapshot.**  The engine, pipeline or rig is deep-copied
  before the trace, so a later ``Engine.load_variables`` does not reach
  into an exported program, saved or not.
- **The batch is symbolic by default** (``torch.export.Dim``): one engine
  artifact serves any batch.  ``batch=<int>`` pins it.  Departures: an
  engine that runs its backbone frame by frame (``Engine.frame_by_frame``:
  SegFormer and UNet, whose frames would otherwise depend on their batch
  on the card) is exported with a pinned batch only, and so is a program
  whose trace depends on the batch size on its device (on the card,
  PyTorch picks the depthwise convolutions' backend by the batch size, so
  the Xception DeepLab's export guards it): ``batch=None`` is refused
  for both, by name.
- **Host steps stay on the host.**  A pipeline artifact maps ONE frame to
  ``(grid, segmentation)`` as the pipeline's device program receives it:
  for ``host_resize`` pipelines the resized frame, for the ``"i420"``
  transport the packed planes (``ops/yuv.i420_shape``), so ``frame_shape``
  is required there.  A rig artifact maps ``(N_cam, H, W, 3)`` to the
  stitched grid.
- **The device is the export's.**  The header's ``platforms`` names it
  (``["cuda"]`` or ``["cpu"]``) and :class:`Deployed` moves its inputs
  there.
- **A spatially partitioned engine exports for its mesh.**  An engine
  served with a frame's rows over ranks (``parallel/spatial.py``)
  exports a program whose header records ``nr_devices``, the ranks of its
  axis (1 for every other artifact).  Each rank calls the same loaded
  program on the whole input and gets the whole output
  (:meth:`Deployed.call_sharded`): the rank's coordinate is an input of
  the program, so that the artifact exported on one rank serves every
  rank, and the collectives run over the loading process's default group,
  which the exporting mesh's axis must have been too.

The container is ``magic | u32 header length | JSON header | blob``, the
blob being ``torch.export.save``'s bytes; the magic is the port's own, and
a JAX artifact (``BCSG1\\0``) is refused by name.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .ops import cuda as _cuda  # noqa: F401  (registers the bugcar:: ops)

MAGIC = b"BCSGPT1\x00"
JAX_MAGIC = b"BCSG1\x00"

# Engine endpoints exportable by name.
ENGINE_ENDPOINTS = ("predict", "predict_binary", "logits")
MAX_BATCH = 65535     # the kernels' grid limit on the batch


class _Frozen(torch.nn.Module):
    """The traced program: ``fn`` over the snapshot, whose modules are
    registered here so that their weights become the program's state."""

    def __init__(self, fn: Callable, module: torch.nn.Module):
        super().__init__()
        self.net = module
        self.fn = fn

    def forward(self, x: torch.Tensor):
        return self.fn(x)


class _FrozenSharded(_Frozen):
    """The same for a spatially partitioned engine: the rank's coordinate
    on the axis (``rows``, a ``parallel/halo.RowShards``) is an input."""

    def __init__(self, fn: Callable, module: torch.nn.Module, rows):
        super().__init__(fn, module)
        self.rows = rows

    def forward(self, x: torch.Tensor, index: torch.Tensor):
        with self.rows.at(index):
            return self.fn(x)


def _trace(fn: Callable, module, example: torch.Tensor,
           batch_dim: bool, rows=None) -> torch.export.ExportedProgram:
    batch = {0: torch.export.Dim("batch", min=1, max=MAX_BATCH)}
    if rows is None:
        frozen, args = _Frozen(fn, module), (example,)
        dynamic = {"x": batch} if batch_dim else None
    else:
        frozen = _FrozenSharded(fn, module, rows)
        args = (example, torch.zeros((), dtype=torch.int64,
                                     device=example.device))
        dynamic = {"x": batch, "index": None} if batch_dim else None
    # under no_grad the models' own no_grad scopes trace to nothing (a
    # grad-mode node would not survive torch.export.save)
    with torch.no_grad():
        return torch.export.export(frozen, args, dynamic_shapes=dynamic)


def export_engine(engine: Any, fn: str = "predict",
                  batch: Optional[int] = None
                  ) -> torch.export.ExportedProgram:
    """Freeze one engine endpoint into an ``ExportedProgram`` on the
    engine's device.

    Args:
      engine: an :class:`~.models.api.Engine` (snapshotted).
      fn: "predict" (uint8 BGR (B, H, W, 3) → uint8 3-class maps at the
        input resolution), "predict_binary" (→ {0, 1} road masks) or
        "logits" (→ f32 logits, NHWC, at the head's resolution).
      batch: None for a symbolic batch, or a static size.
    """
    if fn not in ENGINE_ENDPOINTS:
        raise ValueError(f"fn must be one of {ENGINE_ENDPOINTS}, got {fn!r}")
    if batch is None and engine.frame_by_frame:
        raise ValueError(
            f"engine {engine.name!r} runs its backbone frame by frame "
            f"(Engine.frame_by_frame) so that a frame's labels do not depend "
            f"on its batch; a symbolic batch would trace that loop at one "
            f"size, so pass batch=<int>")
    if batch is not None and int(batch) < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    rows = getattr(engine, "spatial", None)
    if rows is not None and rows.group is not dist.group.WORLD:
        raise ValueError(
            f"engine {engine.name!r} splits its rows over a mesh axis of "
            f"{rows.size} of the {dist.get_world_size()} ranks; a sharded "
            f"artifact runs over the default group, so export it from a "
            f"mesh whose spatial axis holds every rank")
    snap = copy.deepcopy(engine)
    endpoint = {"predict": snap.segment,
                "predict_binary": lambda f: snap.segment(f, "binary"),
                "logits": snap.forward}[fn]
    cfg = snap.cfg
    # a symbolic batch is traced at 2 (sizes 0 and 1 specialise)
    n = 2 if batch is None else int(batch)
    example = torch.zeros((n, cfg.input_height, cfg.input_width, 3),
                          dtype=torch.uint8, device=snap.device)
    try:
        return _trace(endpoint, snap.forward_fn, example, batch is None,
                      rows)
    except torch._dynamo.exc.UserError as e:
        if batch is not None:
            raise
        guard = next((ln.strip() for ln in str(e).splitlines()
                      if "guard" in ln), str(e).splitlines()[0])
        raise ValueError(
            f"engine {engine.name!r} does not export with a symbolic batch "
            f"on {snap.device.type}: its program depends on the batch size "
            f"there ({guard}); pass batch=<int>") from e


def _unsharded(engine: Any) -> None:
    if getattr(engine, "spatial", None) is not None:
        raise ValueError(
            f"engine {engine.name!r} is spatially partitioned; a sharded "
            f"artifact is an engine endpoint (export_engine)")


def export_pipeline(pipeline: Any,
                    frame_shape: Optional[Tuple[int, ...]] = None
                    ) -> torch.export.ExportedProgram:
    """Freeze a :class:`~.pipeline.Pipeline`'s device program: ONE frame,
    as ``_upload`` ships it, → ``(grid, segmentation)``.

    Args:
      frame_shape: the input's shape.  Default: the model resolution
        ``(H, W, 3)``, what a ``host_resize`` BGR pipeline ships.  For
        ``transport="i420"`` pass the packed plane shape ``(3H/2, W)``
        (``ops/yuv.i420_shape``); for the device-side resize, the capture
        shape.
    """
    _unsharded(pipeline.engine)
    if frame_shape is None:
        if pipeline.transport != "bgr":
            raise ValueError(
                "frame_shape is required for non-BGR transports (pass the "
                "packed I420 plane shape, ops/yuv.py i420_shape)")
        h, w = pipeline._model_hw
        frame_shape = (h, w, 3)
    snap = copy.deepcopy(pipeline)

    def frozen(frame: torch.Tensor):
        grids, segs = snap._program(frame[None])
        return grids[0], segs[0]

    example = torch.zeros(tuple(frame_shape), dtype=torch.uint8,
                          device=snap.device)
    return _trace(frozen, snap.engine.forward_fn, example, False)


def export_multicam(pipeline: Any) -> torch.export.ExportedProgram:
    """Freeze a :class:`~.pipeline.MultiCameraPipeline`: (N_cam, H, W, 3)
    uint8 BGR → the stitched int8 vehicle grid (BASELINE config 4)."""
    _unsharded(pipeline.engine)
    snap = copy.deepcopy(pipeline)
    cfg = snap.engine.cfg
    example = torch.zeros((len(snap.builders), cfg.input_height,
                           cfg.input_width, 3), dtype=torch.uint8,
                          device=snap.engine.device)
    return _trace(snap.__call__, snap.engine.forward_fn, example, False)


def _aval(node: torch.fx.Node) -> str:
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        return repr(val)
    dims = ", ".join(str(d) for d in val.shape)
    return f"{str(val.dtype).replace('torch.', '')}[{dims}]"


def _platform(exported: torch.export.ExportedProgram) -> str:
    for node in exported.graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder" and isinstance(val, torch.Tensor):
            return val.device.type
    return "cpu"


def save_artifact(path: str, exported: torch.export.ExportedProgram,
                  meta: Optional[dict] = None) -> None:
    """Write ``magic | u32 header length | JSON header | blob``.

    The header carries ``meta``, the program's input and output shapes
    (``in_avals``, ``out_avals``), ``platforms`` (the device it was
    exported on) and ``nr_devices`` (``meta``'s, else 1), readable without
    loading the program."""
    nodes = {n.name: n for n in exported.graph.nodes}
    sig = exported.graph_signature
    header = dict(meta or {})
    header["in_avals"] = [_aval(nodes[name]) for name in sig.user_inputs]
    header["out_avals"] = [_aval(nodes[name]) for name in sig.user_outputs]
    header["platforms"] = [_platform(exported)]
    header["nr_devices"] = int(header.get("nr_devices", 1))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(buf.getvalue())


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


class Deployed:
    """A loaded artifact: callable on numpy arrays or tensors (moved to
    the artifact's device), with its header as ``.meta``."""

    def __init__(self, exported: torch.export.ExportedProgram, meta: dict):
        self.exported = exported
        self.meta = meta
        self.device = torch.device(meta["platforms"][0])
        self._module = exported.module()

    @torch.no_grad()
    def __call__(self, *args):
        if self.nr_devices > 1:
            raise ValueError(
                f"this artifact was exported for {self.nr_devices} devices; "
                f"run it with call_sharded(mesh, ...) on every rank")
        return self._module(*(_tensor(a).to(self.device) for a in args))

    @torch.no_grad()
    def call_sharded(self, mesh, *args):
        """Run the artifact on this rank of ``mesh`` (``parallel.Mesh``),
        which must hold exactly :attr:`nr_devices` ranks; its axis names
        do not matter.  Every rank passes the whole input and gets the
        whole output."""
        if mesh.world_size != self.nr_devices:
            raise ValueError(
                f"artifact was exported for {self.nr_devices} devices, "
                f"mesh has {mesh.world_size}")
        if self.nr_devices == 1:
            return self._module(*(_tensor(a).to(self.device) for a in args))
        index = torch.tensor(mesh.rank, dtype=torch.int64,
                             device=self.device)
        return self._module(*(_tensor(a).to(self.device) for a in args),
                            index)

    def predict(self, frames_bgr) -> torch.Tensor:
        """Engine.predict-shaped convenience: (H, W, 3) or (B, H, W, 3)
        for an engine artifact."""
        frames = _tensor(frames_bgr)
        if frames.dim() == 3 and self.meta.get("kind") == "engine":
            return self(frames[None])[0]
        return self(frames)

    @property
    def nr_devices(self) -> int:
        """Devices the program was exported for (1: one card; more: the
        ranks of a spatially partitioned engine's axis)."""
        return int(self.meta["nr_devices"])


def load_artifact(path: str) -> Deployed:
    """Read a :func:`save_artifact` file back into a callable.

    Needs torch and the ``bugcar::`` op registrations only; none of the
    model code (``models/``, ``convert/``, ``pipeline``, ``grid``) is
    imported."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JAX_MAGIC):
        raise ValueError(f"{path!r} is a jax.export artifact of the JAX "
                         f"package (magic {JAX_MAGIC!r}); this loader reads "
                         f"the port's torch.export artifacts")
    if not data.startswith(MAGIC):
        raise ValueError(f"{path!r} is not a bugcar deploy artifact "
                         f"(bad magic {data[:len(MAGIC)]!r})")
    if len(data) < len(MAGIC) + 4:
        raise ValueError(f"{path!r} is truncated (no header length)")
    (hlen,) = struct.unpack_from("<I", data, len(MAGIC))
    off = len(MAGIC) + 4
    if off + hlen > len(data):
        raise ValueError(
            f"{path!r} is truncated or corrupt: header claims {hlen} "
            f"bytes but only {len(data) - off} remain")
    meta = json.loads(data[off:off + hlen].decode("utf-8"))
    try:
        exported = torch.export.load(io.BytesIO(data[off + hlen:]))
    except Exception as e:
        raise ValueError(f"{path!r} is truncated or corrupt: its program "
                         f"does not load ({type(e).__name__}: {e})") from e
    return Deployed(exported, meta)


def _name(engine: Any) -> str:
    return getattr(engine.cfg, "name", "?")


def export_engine_to(path: str, engine: Any, fn: str = "predict",
                     batch: Optional[int] = None,
                     meta: Optional[dict] = None) -> None:
    """:func:`export_engine` + :func:`save_artifact` with standard meta."""
    exported = export_engine(engine, fn=fn, batch=batch)
    header = {"kind": "engine", "fn": fn, "model": _name(engine),
              "engine": engine.name,
              "input_hw": [engine.cfg.input_height, engine.cfg.input_width],
              "num_classes": engine.cfg.num_classes}
    if getattr(engine, "spatial", None) is not None:
        header["nr_devices"] = engine.spatial.size
    header.update(meta or {})
    save_artifact(path, exported, header)


def export_pipeline_to(path: str, pipeline: Any,
                       frame_shape: Optional[Tuple[int, ...]] = None,
                       meta: Optional[dict] = None) -> None:
    """:func:`export_pipeline` + :func:`save_artifact` with standard meta."""
    exported = export_pipeline(pipeline, frame_shape=frame_shape)
    header = {"kind": "pipeline", "mode": pipeline.mode,
              "transport": pipeline.transport,
              "model": _name(pipeline.engine),
              "engine": pipeline.engine.name,
              "input_hw": list(pipeline._model_hw)}
    header.update(meta or {})
    save_artifact(path, exported, header)


def export_multicam_to(path: str, pipeline: Any,
                       meta: Optional[dict] = None) -> None:
    """:func:`export_multicam` + :func:`save_artifact` with standard meta."""
    exported = export_multicam(pipeline)
    header = {"kind": "multicam", "n_cameras": len(pipeline.builders),
              "model": _name(pipeline.engine),
              "engine": pipeline.engine.name}
    header.update(meta or {})
    save_artifact(path, exported, header)


__all__ = ["export_engine", "export_pipeline", "export_multicam",
           "save_artifact", "load_artifact", "Deployed", "export_engine_to",
           "export_pipeline_to", "export_multicam_to", "MAGIC",
           "ENGINE_ENDPOINTS"]
