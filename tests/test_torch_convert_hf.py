"""The port's HF SegFormer bridge (``convert/torch_segformer.py``) against
the JAX package's and against HF transformers' own forward.

A tiny random-init ``SegformerForSemanticSegmentation`` (made here, as
tests/test_torch_segformer_bridge.py makes it): the port's state dict is
the JAX bridge's Flax tree through ``segformer_state_dict``, bit for bit;
the port model built from the HF config (``torch_compat``) gives HF's
1/4-resolution logits within 1e-5 (the JAX bridge's budget against the
same forward); the bare-encoder keys convert too, and a checkpoint whose
shapes do not fit raises, naming both keys.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from bugcar_image_segmentation_tpu.convert import torch_segformer as jseg
from bugcar_image_segmentation_tpu_torch.convert import torch_segformer
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
    segformer_state_dict


def tiny_hf(num_labels=5, seed=0, hidden=(8, 16, 40, 64)):
    from transformers import (SegformerConfig,
                              SegformerForSemanticSegmentation)

    torch.manual_seed(seed)
    cfg = SegformerConfig(
        num_channels=3, num_encoder_blocks=4,
        depths=[1, 1, 2, 1], sr_ratios=[8, 4, 2, 1],
        hidden_sizes=list(hidden), num_attention_heads=[1, 2, 5, 8],
        patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
        decoder_hidden_size=32, num_labels=num_labels, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        classifier_dropout_prob=0.0, drop_path_rate=0.0)
    return SegformerForSemanticSegmentation(cfg).eval()


@pytest.fixture(scope="module")
def bridged():
    hf = tiny_hf()
    model, sd = torch_segformer.convert_hf_model(hf,
                                                 head_upsample="quarter")
    return hf, model.eval(), sd


def test_state_dict_is_the_jax_bridge(bridged):
    hf, _, sd = bridged
    want = segformer_state_dict(jseg.convert_state_dict(
        hf.state_dict(), depths=(1, 1, 2, 1)))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k


def test_logits_match_hf(bridged):
    hf, model, _ = bridged
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits \
            .numpy().transpose(0, 2, 3, 1)
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_bare_encoder_keys(bridged):
    hf, model, sd = bridged
    bare = {k[len("segformer."):] if k.startswith("segformer.") else k: v
            for k, v in hf.state_dict().items()}
    got = torch_segformer.convert_state_dict(bare, model)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_shape_mismatch_names_both_keys(bridged):
    _, model, _ = bridged
    other = tiny_hf(hidden=(8, 16, 40, 48))
    with pytest.raises(ValueError, match=r"checkpoint \S+ \(48, 40, 3, 3\) "
                                         r"vs the port's embed3.Conv_0."
                                         r"weight \(64, 40, 3, 3\)"):
        torch_segformer.convert_state_dict(other.state_dict(), model)
