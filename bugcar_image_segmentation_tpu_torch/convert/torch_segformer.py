"""SegFormer checkpoints of HF transformers → the port's SegFormer.

Port of ``bugcar_image_segmentation_tpu/convert/torch_segformer.py``.
The NVlabs SegFormer weights are distributed through HF transformers
(``nvidia/segformer-b0-finetuned-*``, ``nvidia/mit-b*``).  This bridge
maps a ``SegformerForSemanticSegmentation`` state dict onto
:class:`~..models.segformer.SegFormer` built with ``torch_compat=True``
(centred patch-embed padding and the erf GELU, the official conventions;
under the default SAME padding the embeds would sample a shifted
window).  Both are PyTorch modules with the same layouts -- Linear
``(out, in)`` is the port's Dense ``weight``, Conv2d OIHW its conv
``weight``, LayerNorm ``weight`` its ``scale`` -- so the map renames and
copies, shape-checked against the port's model.

``transformers`` is imported inside :func:`load_torch_segformer` only:
conversion is offline tooling, never on the serving path.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def _key_map(depths: Tuple[int, ...]) -> Dict[str, str]:
    """Port state-dict key → HF key (``segformer.`` prefix dropped)."""
    out: Dict[str, str] = {}

    def lin(port: str, hf: str, bias: bool = True) -> None:
        out[f"{port}.weight"] = f"{hf}.weight"
        if bias:
            out[f"{port}.bias"] = f"{hf}.bias"

    def ln(port: str, hf: str) -> None:
        out[f"{port}.scale"] = f"{hf}.weight"
        out[f"{port}.bias"] = f"{hf}.bias"

    for s in range(len(depths)):
        pe = f"encoder.patch_embeddings.{s}"
        lin(f"embed{s}.Conv_0", f"{pe}.proj")
        ln(f"embed{s}.LayerNorm_0", f"{pe}.layer_norm")
        for b in range(depths[s]):
            blk, port = f"encoder.block.{s}.{b}", f"stage{s}_block{b}"
            ln(f"{port}.norm1", f"{blk}.layer_norm_1")
            ln(f"{port}.norm2", f"{blk}.layer_norm_2")
            for name, hf in (("q", "self.query"), ("k", "self.key"),
                             ("v", "self.value"), ("proj", "output.dense"),
                             ("sr", "self.sr")):
                lin(f"{port}.attn.{name}", f"{blk}.attention.{hf}")
            ln(f"{port}.attn.sr_norm", f"{blk}.attention.self.layer_norm")
            lin(f"{port}.ffn.fc1", f"{blk}.mlp.dense1")
            lin(f"{port}.ffn.dwconv", f"{blk}.mlp.dwconv.dwconv")
            lin(f"{port}.ffn.fc2", f"{blk}.mlp.dense2")
        ln(f"norm{s}", f"encoder.layer_norm.{s}")
        # The HF head fuses cat(states[::-1]), as the port's head does:
        # the fuse kernel's input channels map one to one.
        lin(f"linear_c{s}", f"decode_head.linear_c.{s}.proj")
    lin("fuse", "decode_head.linear_fuse", bias=False)
    out["fuse_bn.scale"] = "decode_head.batch_norm.weight"
    out["fuse_bn.bias"] = "decode_head.batch_norm.bias"
    out["fuse_bn.mean"] = "decode_head.batch_norm.running_mean"
    out["fuse_bn.var"] = "decode_head.batch_norm.running_var"
    lin("classifier", "decode_head.classifier")
    return out


def convert_state_dict(state_dict: Dict[str, Any], model
                       ) -> Dict[str, torch.Tensor]:
    """HF ``SegformerForSemanticSegmentation`` state dict → ``model``'s
    (a port :class:`SegFormer`) state dict of float32 tensors.

    Accepts ``segformer.``-prefixed (ForSemanticSegmentation) and bare
    encoder keys.  Every port tensor is filled once and shape-checked;
    a key the map needs and the checkpoint lacks, or a shape that does
    not fit, raises ``ValueError`` naming both sides.  Blocks without
    spatial reduction (``sr_ratio`` 1) have no ``sr`` in either.
    """
    sd = {k[len("segformer."):] if k.startswith("segformer.") else k: v
          for k, v in state_dict.items()}
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for port, hf in _key_map(tuple(model.depths)).items():
        if port not in want:
            continue            # no spatial reduction in this block
        if hf not in sd:
            raise ValueError(f"the checkpoint has no {hf!r} for the port's "
                             f"{port}")
        t = torch.as_tensor(sd[hf]).detach().to("cpu", torch.float32)
        if tuple(t.shape) != tuple(want[port].shape):
            raise ValueError(f"shape mismatch: checkpoint {hf} "
                             f"{tuple(t.shape)} vs the port's {port} "
                             f"{tuple(want[port].shape)}")
        out[port] = t.clone()
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"no checkpoint key fills the port's {missing[:8]}")
    return out


def convert_hf_model(hf_model, **overrides):
    """HF ``SegformerForSemanticSegmentation`` → (port SegFormer with its
    weights, its state dict).

    Reads the architecture from ``hf_model.config`` (hidden sizes, depths,
    heads, SR ratios, decoder width, label count) and builds the port's
    :class:`SegFormer` with ``torch_compat=True``; ``overrides`` pass
    through (``head_upsample="quarter"`` gives the HF output contract:
    logits at 1/4 resolution)."""
    from ..models.segformer import SegFormer

    cfg = hf_model.config
    kw = dict(
        num_classes=cfg.num_labels,
        widths=tuple(cfg.hidden_sizes),
        depths=tuple(cfg.depths),
        num_heads=tuple(cfg.num_attention_heads),
        sr_ratios=tuple(cfg.sr_ratios),
        decoder_dim=cfg.decoder_hidden_size,
        torch_compat=True,
    )
    kw.update(overrides)
    model = SegFormer(**kw)
    sd = convert_state_dict(hf_model.state_dict(), model)
    model.load_state_dict(sd)
    return model, sd


def load_torch_segformer(path: str, **overrides):
    """Checkpoint directory / HF model id → (port SegFormer, state dict),
    through ``SegformerForSemanticSegmentation.from_pretrained`` (give a
    local path on a host without network)."""
    from transformers import SegformerForSemanticSegmentation

    hf = SegformerForSemanticSegmentation.from_pretrained(path)
    return convert_hf_model(hf, **overrides)


__all__ = ["convert_state_dict", "convert_hf_model", "load_torch_segformer"]
