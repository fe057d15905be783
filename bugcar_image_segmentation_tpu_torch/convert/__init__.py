"""Weight bridges between Flax variable trees and the PyTorch port's state
dicts (``flax_*``), and the deploy-format bridges of the JAX package's
``convert/``:

- :mod:`~.tf_graphdef`: frozen TF1 ``.pb`` GraphDefs → a port module's
  state dict, by zipping graph execution order onto Flax parameter
  creation order with a shape check on every leaf;
- :mod:`~.keras_h5`: Keras ``model.h5`` through the same pour;
- :mod:`~.tf_enet` / :mod:`~.tf_xception`: a port ENet / Xception DeepLab
  → the frozen graph the reference serves;
- :mod:`~.torch_segformer`: HF SegFormer checkpoints → the port's
  SegFormer.

TensorFlow, h5py and transformers are imported by the functions that use
them, never at import: they are offline tools, absent on the GPU host.
"""

from .keras_h5 import convert_keras_h5, extract_h5_ops
from .tf_enet import build_enet_tf, export_enet_pb, freeze_function
from .tf_graphdef import (OpExtract, convert_frozen_graph, extract_ops,
                          load_graphdef, param_creation_order,
                          pour_into_module)
from .torch_segformer import (convert_hf_model, convert_state_dict,
                              load_torch_segformer)

__all__ = [
    "OpExtract", "convert_frozen_graph", "extract_ops", "load_graphdef",
    "param_creation_order", "pour_into_module",
    "convert_keras_h5", "extract_h5_ops",
    "build_enet_tf", "export_enet_pb", "freeze_function",
    "convert_hf_model", "convert_state_dict", "load_torch_segformer",
]
