"""Frozen TF1 GraphDef (.pb) → the port's state dicts.

Port of ``bugcar_image_segmentation_tpu/convert/tf_graphdef.py``.  The
reference ships its models as const-folded TF1 GraphDefs (``enet.pb`` /
``deeplab.pb``, loaded with ``tf.import_graph_def`` into a session).
This module walks a frozen GraphDef, extracts every constant,
pattern-matches the parameter-carrying ops (Conv2D /
Conv2DBackpropInput / DepthwiseConv2dNative / MatMul / BiasAdd /
FusedBatchNorm / Prelu, and the decomposed PReLU forms of TF1 exports)
in *graph execution order*, and pours the weights into a port module in
*Flax parameter creation order*, with a shape check on every assignment.

Graph names carry no structure (the reference's output tensor is
``CATkrIDy/concat:0``), so the mapping is by order: a frozen sequential
graph executes in dataflow order, and Flax creates a model's variables in
the order of their first use at ``init``.  A port module registers its
parameters in ``__init__`` order, which can differ, so
:func:`param_creation_order` records the order of first use with forward
pre-hooks on the leaf modules over one eval forward, and names each leaf
by its Flax path (the bridges' names: ``a.b.weight`` ↔
``params/a/b/kernel``, BatchNorm ``mean``/``var`` ↔ ``batch_stats``).
The pour fills the module's Flax-layout tree (``flax_tree.
flax_variables``) as the JAX converter fills its tree, and returns the
module's state dict (``flax_tree.module_state_dict``).

TensorFlow is imported inside the functions that need it: conversion is
offline tooling on a host that has TF, never on the serving path.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _tf():
    import tensorflow as tf  # deferred: offline tooling only
    return tf


# ---------------------------------------------------------------------------
# GraphDef parsing
# ---------------------------------------------------------------------------


def load_graphdef(pb_path: str):
    """Parse a frozen ``.pb`` file into a GraphDef proto."""
    tf = _tf()
    graph_def = tf.compat.v1.GraphDef()
    with open(pb_path, "rb") as f:
        graph_def.ParseFromString(f.read())
    return graph_def


def extract_constants(graph_def) -> Dict[str, np.ndarray]:
    """All Const node values, name → ndarray."""
    tf = _tf()
    return {node.name: tf.make_ndarray(node.attr["value"].tensor)
            for node in graph_def.node if node.op == "Const"}


class OpExtract(collections.namedtuple("OpExtract",
                                       ["kind", "name", "arrays"])):
    """One parameter-carrying op found in the graph.

    kind ∈ {conv, conv_transpose, depthwise, dense, bias, batchnorm, prelu};
    arrays: kind-dependent numpy weights in TF-native layout.
    """


_CONV_FAMILY = ("Conv2D", "DepthwiseConv2dNative", "Conv2DBackpropInput",
                "MatMul")


def _is_float(arr) -> bool:
    return arr is not None and np.asarray(arr).dtype.kind == "f"


def extract_ops(graph_def) -> List[OpExtract]:
    """Parameter-carrying ops in graph (execution) order.

    Frozen graphs list nodes in a valid execution order; each compute op is
    paired with the Const feeding its weight input, resolving through
    Identity/ReadVariableOp/Cast/Neg indirections.

    Era-correct TF1 export patterns handled (the actual ``enet.pb`` /
    ``deeplab.pb`` blobs are stripped — ``.MISSING_LARGE_BLOBS`` — so the
    matching is written against the graphs those exports would contain):

    - **Decomposed PReLU** — stock TF1 has no ``Prelu`` op; ENet-era graphs
      express it as ``relu(x) + alpha*(x-|x|)*0.5`` (slim convention) or
      ``relu(x) - alpha*relu(-x)`` / Keras's ``relu(x) + (-alpha)*relu(-x)``.
      :func:`_match_decomposed_prelu` recovers the effective per-channel
      alpha from any algebraic variant of these.
    - **MaxPoolWithArgmax + ScatterNd unpooling** (ENet decoder,
      SURVEY.md §7 "the nastiest op") carries no parameters, but its index
      arithmetic is integer Mul/Add/Sub soup — all weight extraction is
      float-gated so none of it is misread as biases or alphas.
    - **DeepLab-style preambles** (embedded resize / mean-subtract /
      final ArgMax, reference models.py:100-101): size and axis constants
      are integers (skipped); mean/scale arithmetic rides Sub/RealDiv/
      scalar-Mul nodes, none of which match a weight pattern.
    - Generic ``Add``-as-bias only counts when it actually terminates a
      conv/matmul (its non-const input must resolve to a conv-family op
      through trivial indirections) — preprocessing adds never do.
    """
    consts = extract_constants(graph_def)
    by_name = {n.name: n for n in graph_def.node}

    def producer(name: str):
        return by_name.get(name.split(":")[0].lstrip("^"))

    def resolve_const(name: str) -> Optional[np.ndarray]:
        name = name.split(":")[0].lstrip("^")
        seen = set()
        negate = False
        while name in by_name and name not in seen:
            seen.add(name)
            node = by_name[name]
            if node.op == "Const":
                val = consts[node.name]
                return -val if negate else val
            if node.op in ("Identity", "ReadVariableOp", "Enter", "Cast"):
                name = node.input[0].split(":")[0]
                continue
            if node.op == "Neg":
                negate = not negate
                name = node.input[0].split(":")[0]
                continue
            return None
        return None

    # consumers: node name -> [node] (data edges only)
    consumers: Dict[str, List] = collections.defaultdict(list)
    for node in graph_def.node:
        for inp in node.input:
            if not inp.startswith("^"):
                consumers[inp.split(":")[0]].append(node)

    def _trivial_source(name: str):
        """Producer node, looking through no-op indirections."""
        node = producer(name)
        seen = set()
        while node is not None and node.name not in seen and \
                node.op in ("Identity", "Cast", "Reshape", "Squeeze",
                            "ExpandDims"):
            seen.add(node.name)
            node = producer(node.input[0])
        return node

    def _match_decomposed_prelu(mul_node) -> Optional[np.ndarray]:
        """If ``mul_node`` is the alpha-Mul of a decomposed PReLU, return
        the effective per-channel alpha, else None.

        The negative branch of every known decomposition is
        ``alpha ⊙ k · min(x, 0)`` for some scalar chain ``k``:
        ``x-|x|`` contributes k=2 (``|x|-x`` k=-2), ``relu(-x)`` k=-1,
        ``minimum(x,0)`` k=1; scalar const Muls (the slim 0.5) fold into
        k; an ``Add`` combiner keeps the sign, a ``Sub`` combiner (with
        the branch as subtrahend) flips it.  The combiner's other input
        must be a ``Relu`` — that is what separates a PReLU alpha-Mul
        from e.g. a const-folded batchnorm Mul.
        """
        c = None
        branch = None
        for inp in mul_node.input:
            val = resolve_const(inp)
            if val is not None and _is_float(val) and np.size(val) > 1:
                c = val
            elif resolve_const(inp) is None:
                branch = inp
        if c is None or branch is None:
            return None

        # Walk UP through scalar muls to the shape-defining node.
        k = 1.0
        node = _trivial_source(branch)
        seen = set()
        while node is not None and node.name not in seen:
            seen.add(node.name)
            if node.op == "Mul":
                scal = [resolve_const(i) for i in node.input]
                scal_const = next((s for s in scal
                                   if s is not None and np.size(s) == 1
                                   and _is_float(s)), None)
                if scal_const is None:
                    return None
                k *= float(np.ravel(scal_const)[0])
                other = next(i for i in node.input
                             if resolve_const(i) is None)
                node = _trivial_source(other)
                continue
            break
        if node is None:
            return None

        if node.op == "Sub":
            a, b = node.input[0], node.input[1]
            pa, pb = _trivial_source(a), _trivial_source(b)
            if pb is not None and pb.op == "Abs":
                k *= 2.0          # x - |x| = 2 min(x, 0)
            elif pa is not None and pa.op == "Abs":
                k *= -2.0         # |x| - x = -2 min(x, 0)
            else:
                return None
        elif node.op == "Relu":
            inner = _trivial_source(node.input[0])
            if inner is None or inner.op != "Neg":
                return None
            k *= -1.0             # relu(-x) = -min(x, 0)
        elif node.op == "Minimum":
            vals = [resolve_const(i) for i in node.input]
            if not any(v is not None and np.size(v) == 1
                       and float(np.ravel(v)[0]) == 0.0 for v in vals):
                return None
            # min(x, 0): k *= 1
        else:
            return None

        # Walk DOWN from the alpha-Mul through scalar muls to the combiner.
        cur = mul_node
        seen = set()
        while cur.name not in seen:
            seen.add(cur.name)
            outs = consumers.get(cur.name, [])
            if len(outs) != 1:
                return None
            nxt = outs[0]
            if nxt.op == "Mul":
                scal = [resolve_const(i) for i in nxt.input]
                scal_const = next((s for s in scal
                                   if s is not None and np.size(s) == 1
                                   and _is_float(s)), None)
                if scal_const is None:
                    return None
                k *= float(np.ravel(scal_const)[0])
                cur = nxt
                continue
            if nxt.op in ("Add", "AddV2", "Sub"):
                if nxt.op == "Sub":
                    # branch must be the subtrahend: relu(x) - branch
                    if nxt.input[1].split(":")[0] != cur.name:
                        return None
                    k *= -1.0
                # The positive branch must be a Relu — the PReLU signature.
                other = (nxt.input[0] if
                         nxt.input[1].split(":")[0] == cur.name
                         else nxt.input[1])
                pos = _trivial_source(other)
                if pos is None or pos.op != "Relu":
                    return None
                return (np.asarray(c, dtype=np.float32).reshape(-1)
                        * np.float32(k))
            return None
        return None

    ops: List[OpExtract] = []
    for node in graph_def.node:
        if node.op == "Conv2D":
            w = resolve_const(node.input[1])
            if _is_float(w):
                ops.append(OpExtract("conv", node.name, {"kernel": w}))
        elif node.op == "DepthwiseConv2dNative":
            w = resolve_const(node.input[1])
            if _is_float(w):
                ops.append(OpExtract("depthwise", node.name, {"kernel": w}))
        elif node.op == "Conv2DBackpropInput":  # transposed conv
            w = resolve_const(node.input[1])
            if _is_float(w):
                ops.append(OpExtract("conv_transpose", node.name,
                                     {"kernel": w}))
        elif node.op == "MatMul":
            w = resolve_const(node.input[1])
            if _is_float(w):
                ops.append(OpExtract("dense", node.name, {"kernel": w}))
        elif node.op == "BiasAdd":
            b = resolve_const(node.input[1])
            if _is_float(b) and b.ndim <= 1:
                ops.append(OpExtract("bias", node.name, {"bias": b}))
        elif node.op in ("AddV2", "Add"):
            b = resolve_const(node.input[1])
            src = _trivial_source(node.input[0])
            if (_is_float(b) and b.ndim <= 1 and src is not None
                    and src.op in _CONV_FAMILY):
                ops.append(OpExtract("bias", node.name, {"bias": b}))
        elif node.op in ("FusedBatchNorm", "FusedBatchNormV2",
                         "FusedBatchNormV3"):
            arrays = {}
            for key, inp in zip(("scale", "offset", "mean", "variance"),
                                node.input[1:5]):
                val = resolve_const(inp)
                if val is None:
                    arrays = None
                    break
                arrays[key] = val
            if arrays is not None:
                arrays["epsilon"] = np.float32(
                    node.attr["epsilon"].f if "epsilon" in node.attr
                    else 1e-3)
                ops.append(OpExtract("batchnorm", node.name, arrays))
        elif node.op == "Prelu":
            # Not a stock TF1 op, but some exporters emit it fused.
            a = resolve_const(node.input[1])
            if _is_float(a):
                ops.append(OpExtract("prelu", node.name, {"alpha": a}))
        elif node.op == "Mul":
            a = _match_decomposed_prelu(node)
            if a is not None:
                ops.append(OpExtract("prelu", node.name, {"alpha": a}))
    return ops


# ---------------------------------------------------------------------------
# Flax parameter creation order
# ---------------------------------------------------------------------------


LeafRef = Tuple[str, Tuple[str, ...]]  # (collection, path within collection)

# The order in which a Flax leaf module creates its variables: BatchNorm
# its running statistics, then scale and bias; Conv / Dense their kernel,
# then bias; LayerNorm scale, then bias; PReLU its alpha.
_CREATION_RANK = {"mean": 0, "var": 1, "weight": 2, "scale": 3, "bias": 4,
                  "alpha": 5}
# The JAX ENet's inference path lowers its initial block and the
# bottlenecks of at most 64 channels (stages 1, 4 and 5) through its CHW
# and phase-domain twins, whose BatchNorms create scale and bias first.
# This rule exists only so that the returned list equals the JAX
# converter's leaf for leaf: no pour depends on it, since
# :func:`pour_into_module` fills all four leaves of a BatchNorm from one
# graph op, whatever their order within the module.
_PARAMS_FIRST = {"weight": 0, "scale": 1, "bias": 2, "mean": 3, "var": 4,
                 "alpha": 5}


def _params_first(module) -> set:
    """Names of ``module``'s BatchNorms that Flax creates scale-first."""
    from ..models.enet import BatchNorm, Bottleneck, InitialBlock

    out = set()
    for name, block in module.named_modules():
        if (isinstance(block, InitialBlock)
                or isinstance(block, Bottleneck) and block.features <= 64):
            out.update(f"{name}.{sub}" if name else sub
                       for sub, m in block.named_modules()
                       if isinstance(m, BatchNorm))
    return out


def _leaf_ref(key: str) -> LeafRef:
    """A port state-dict key → its Flax (collection, path)."""
    path = key.split(".")
    leaf = path[-1]
    if leaf in ("mean", "var"):
        return "batch_stats", tuple(path)
    return "params", tuple(path[:-1]) + ("kernel" if leaf == "weight"
                                         else leaf,)


def _first_uses(module, example_input) -> List[str]:
    """The names of ``module``'s leaf modules (those that own state-dict
    tensors) in the order of their first use over one eval forward: a
    module is used when it is called (a forward pre-hook) or when a torch
    function reads one of its tensors (a ``TorchFunctionMode``; a method
    such as SegFormer's ``Dense.forward_t`` reads its weight without a
    call)."""
    import torch
    from torch.overrides import TorchFunctionMode

    owner: Dict[int, str] = {}
    names = set()
    for key, t in module.state_dict(keep_vars=True).items():
        name = key.rpartition(".")[0]
        owner[id(t)] = name
        names.add(name)
    events: List[str] = []

    class FirstUse(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            for a in (*args, *kwargs.values()):
                for t in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(t, torch.Tensor) and id(t) in owner:
                        events.append(owner[id(t)])
            return func(*args, **kwargs)

    hooks = [sub.register_forward_pre_hook(
        lambda _m, _a, name=name: events.append(name))
        for name, sub in module.named_modules() if name in names]
    was_training = module.training
    try:
        module.eval()
        device = next(module.parameters()).device
        x = torch.as_tensor(np.asarray(example_input, np.float32),
                            device=device)
        with torch.no_grad(), FirstUse():
            module(x)
    finally:
        for h in hooks:
            h.remove()
        module.train(was_training)
    order = list(dict.fromkeys(events))
    return order + sorted(names - set(order), key=list(owner.values()).index)


def param_creation_order(module, example_input
                         ) -> Tuple[dict, List[LeafRef]]:
    """Run ``module`` once in eval mode on ``example_input`` (an NHWC
    tensor or array) and order its variables as Flax's ``init`` creates
    them, the order a frozen graph executes in.

    Returns (the module's Flax-layout variables, the ordered leaf refs):
    the leaf modules in the order of their first use (:func:`_first_uses`;
    one never used keeps its registration place after the used ones),
    each module's variables in Flax's order within it (for ENet's
    lowered blocks, scale first: ``_PARAMS_FIRST``, kept only so that the
    list equals the JAX converter's).  Build ``module`` on its textbook
    path, as the JAX converter inits the Flax module: a
    fused kernel (Xception's ``_fs``) or a folded head reads its weights
    folded, in another order.
    """
    from .flax_tree import flax_variables

    params_first = _params_first(module)
    keys: Dict[str, List[str]] = collections.defaultdict(list)
    for key in module.state_dict():
        keys[key.rpartition(".")[0]].append(key)
    order = []
    for name in _first_uses(module, example_input):
        rank = _PARAMS_FIRST if name in params_first else _CREATION_RANK
        order += [_leaf_ref(k) for k in sorted(
            keys[name], key=lambda k: rank[k.rpartition(".")[2]])]
    return flax_variables(module), order


# ---------------------------------------------------------------------------
# Weight layout conversion
# ---------------------------------------------------------------------------


def convert_conv_kernel(w: np.ndarray) -> np.ndarray:
    """TF Conv2D kernels are HWIO — exactly Flax's layout."""
    return np.asarray(w)


def convert_deconv_kernel(w: np.ndarray) -> np.ndarray:
    """TF Conv2DBackpropInput (H, W, out, in) → Flax ConvTranspose
    (H, W, in, out).

    TF's deconv is the gradient of a correlation (spatially mirrored
    taps); Flax's ``nn.ConvTranspose`` is a fractionally-strided
    correlation — so the conversion both mirrors the spatial axes and
    swaps in/out (verified numerically in tests/test_convert.py).
    """
    return np.asarray(w)[::-1, ::-1].transpose(0, 1, 3, 2)


def convert_depthwise_kernel(w: np.ndarray) -> np.ndarray:
    """TF depthwise (H, W, C, mult) → Flax grouped-conv (H, W, 1, C*mult)."""
    h, ww, c, m = w.shape
    return np.asarray(w).reshape(h, ww, 1, c * m)


def fold_batchnorm(scale, offset, mean, variance, epsilon):
    """Inference-mode BN folded to (multiplier, shift): y = x*mult + shift."""
    inv = scale / np.sqrt(variance + epsilon)
    return inv.astype(np.float32), (offset - mean * inv).astype(np.float32)


# ---------------------------------------------------------------------------
# Pouring
# ---------------------------------------------------------------------------


def _get(tree: dict, path: Sequence[str]):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: Sequence[str], value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def pour_into_module(module, example_input,
                     ops: Sequence[OpExtract]) -> dict:
    """Zip graph-order ops onto ``module``'s leaves in Flax creation order
    and return its state dict (float32 tensors) with the graph's weights.

    Every assignment is shape-checked; a mismatch raises naming both the
    graph op and the Flax path.  Leaves no op fills keep the module's
    current values.
    """
    from .flax_tree import module_state_dict

    out, order = param_creation_order(module, example_input)

    queues: Dict[str, collections.deque] = collections.defaultdict(
        collections.deque)
    for op in ops:
        queues[op.kind].append(op)

    def take(kind: str, flax_path) -> OpExtract:
        if not queues[kind]:
            raise ValueError(
                f"graph has no more {kind!r} weights for Flax leaf "
                f"{'/'.join(flax_path)}")
        return queues[kind].popleft()

    def assign(col, path, value, op_name):
        leaf = _get(out[col], path)
        value = np.asarray(value)
        if value.shape != np.shape(leaf):
            raise ValueError(
                f"shape mismatch pouring graph op {op_name!r} into "
                f"{col}/{'/'.join(path)}: graph {value.shape} vs model "
                f"{np.shape(leaf)}")
        _set(out[col], path, value.astype(np.asarray(leaf).dtype))

    # BN modules contribute 4 leaves across two collections; remember the
    # extracted arrays per module path.
    bn_arrays: Dict[Tuple[str, ...], dict] = {}

    def module_siblings(col, path):
        return set(_get(out[col], path[:-1]).keys())

    for col, path in order:
        leaf_name = path[-1]
        mod_path = path[:-1]
        sibs = module_siblings(col, path)

        is_bn = ("scale" in sibs) or mod_path in bn_arrays
        if col == "batch_stats" or (col == "params" and is_bn
                                    and leaf_name in ("scale", "bias")):
            if mod_path not in bn_arrays:
                op = take("batchnorm", path)
                bn_arrays[mod_path] = dict(op.arrays, _name=op.name)
            arrays = bn_arrays[mod_path]
            tf_key = {"scale": "scale", "bias": "offset",
                      "mean": "mean", "var": "variance"}[leaf_name]
            assign(col, path, arrays[tf_key], arrays["_name"])
            continue

        if leaf_name == "kernel":
            leaf = _get(out[col], path)
            if queues["depthwise"] and np.shape(leaf)[2] == 1:
                op = take("depthwise", path)
                assign(col, path, convert_depthwise_kernel(
                    op.arrays["kernel"]), op.name)
            elif np.ndim(leaf) == 2:
                op = take("dense", path)
                assign(col, path, op.arrays["kernel"], op.name)
            else:
                # A conv leaf matches whichever conv-family op comes next
                # in graph order (plain vs transposed).
                next_plain = queues["conv"][0] if queues["conv"] else None
                next_tr = (queues["conv_transpose"][0]
                           if queues["conv_transpose"] else None)

                def fits(op, convert):
                    return (op is not None and
                            convert(op.arrays["kernel"]).shape
                            == np.shape(leaf))

                if fits(next_plain, convert_conv_kernel):
                    op = take("conv", path)
                    assign(col, path, convert_conv_kernel(
                        op.arrays["kernel"]), op.name)
                elif fits(next_tr, convert_deconv_kernel):
                    op = take("conv_transpose", path)
                    assign(col, path, convert_deconv_kernel(
                        op.arrays["kernel"]), op.name)
                else:
                    raise ValueError(
                        f"no conv-family graph op matches Flax leaf "
                        f"{'/'.join(path)} of shape {np.shape(leaf)}")
        elif leaf_name == "bias":
            op = take("bias", path)
            assign(col, path, op.arrays["bias"], op.name)
        elif leaf_name == "alpha":
            op = take("prelu", path)
            assign(col, path, np.asarray(op.arrays["alpha"]).reshape(-1),
                   op.name)
        # Other leaves (layernorm, …) keep the module's values; extend the
        # kind table when a graph needs them.

    return module_state_dict(out, module)


def convert_frozen_graph(pb_path: str, module, example_input) -> dict:
    """One call: ``.pb`` + port module → its state dict with the graph's
    weights::

        eng = build_engine("enet", device="cpu")
        sd = convert_frozen_graph("enet.pb", eng.module,
                                  np.zeros((1, 256, 512, 3), np.float32))
        eng.load_variables(sd)
    """
    return pour_into_module(module, example_input,
                            extract_ops(load_graphdef(pb_path)))


__all__ = [
    "load_graphdef", "extract_constants", "extract_ops", "OpExtract",
    "param_creation_order", "fold_batchnorm",
    "convert_conv_kernel", "convert_deconv_kernel",
    "convert_depthwise_kernel", "pour_into_module", "convert_frozen_graph",
]
