"""Keras ``model.h5`` → the port's state dicts.

Port of ``bugcar_image_segmentation_tpu/convert/keras_h5.py``.  The
reference's third backbone is a Keras ``model.h5`` whose loading code did
not survive.  This reads the HDF5 weight layout Keras has used since 1.x
-- ``model_weights/<layer>/...`` with ``layer_names`` / ``weight_names``
attributes recording build order --, turns each layer into the
:class:`~.tf_graphdef.OpExtract` stream the GraphDef walker produces, and
pours it with :func:`~.tf_graphdef.pour_into_module` into a port module
(``models/unet.py``'s UNet, say).

Only ``h5py`` is needed, imported inside :func:`extract_h5_ops`; Keras and
TF are not.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .tf_graphdef import OpExtract, pour_into_module


def _decode(names) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def extract_h5_ops(h5_path: str) -> List[OpExtract]:
    """Walk a Keras ``.h5`` file into OpExtracts in layer build order."""
    import h5py

    ops: List[OpExtract] = []
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = _decode(root.attrs.get("layer_names", list(root)))
        for lname in layer_names:
            g = root[lname]
            weight_names = _decode(g.attrs.get("weight_names", []))
            if not weight_names:
                continue
            arrays = {wn.split("/")[-1].split(":")[0]: np.asarray(g[wn])
                      for wn in weight_names}

            if {"gamma", "beta", "moving_mean",
                    "moving_variance"} <= arrays.keys():
                ops.append(OpExtract("batchnorm", lname, {
                    "scale": arrays["gamma"], "offset": arrays["beta"],
                    "mean": arrays["moving_mean"],
                    "variance": arrays["moving_variance"],
                    "epsilon": np.float32(1e-3),
                }))
            elif "depthwise_kernel" in arrays:
                ops.append(OpExtract("depthwise", lname,
                                     {"kernel": arrays["depthwise_kernel"]}))
                if "bias" in arrays:
                    ops.append(OpExtract("bias", lname,
                                         {"bias": arrays["bias"]}))
            elif "kernel" in arrays:
                k = arrays["kernel"]
                if k.ndim == 4:
                    # Keras Conv2DTranspose kernels are (H, W, out, in) —
                    # the same layout as TF's Conv2DBackpropInput — while
                    # Conv2D is HWIO.  Distinguish by layer name, the only
                    # signal the h5 carries.
                    transposed = ("transpose" in lname.lower()
                                  or "deconv" in lname.lower())
                    ops.append(OpExtract(
                        "conv_transpose" if transposed else "conv",
                        lname, {"kernel": k}))
                elif k.ndim == 2:
                    ops.append(OpExtract("dense", lname, {"kernel": k}))
                if "bias" in arrays:
                    ops.append(OpExtract("bias", lname,
                                         {"bias": arrays["bias"]}))
            elif "alpha" in arrays:
                ops.append(OpExtract("prelu", lname,
                                     {"alpha": arrays["alpha"]}))
    return ops


def convert_keras_h5(h5_path: str, module, example_input) -> dict:
    """One call: ``model.h5`` + port module → its state dict with the
    file's weights."""
    return pour_into_module(module, example_input, extract_h5_ops(h5_path))


__all__ = ["extract_h5_ops", "convert_keras_h5"]
