"""The port's augmentation (``training/augment.py``) against the JAX
package's ``augment_batch``.

The JAX function draws its per-sample parameters from eight keys split
off its key (its training/augment.py:101); the test draws the same
values with the same splits, hands them to the port's
:func:`apply_params`, and holds the result to ``augment_batch``'s:
labels exactly, images within 1e-5: XLA computes the source coordinate
``cx + (j - (W-1)/2) * scale`` with a fused multiply-add, so it can land
one ulp (3.8e-6 below x = 64) from the port's, and a bilinear weight is
``sx - floor(sx)`` (measured <= 3.3e-6 at these sizes).  Then the port's own
draw: shapes, dtypes, determinism per generator, the identity config and
the zoom-out ignore fill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.training.augment import (
    AugmentConfig as JAugmentConfig, augment_batch as jaugment)
from bugcar_image_segmentation_tpu_torch.training.augment import (
    AugmentConfig, apply_params, augment_batch, draw_params)

IMAGE_ATOL = 1e-5


def jax_params(key, shape, cfg):
    """augment_batch's per-sample parameters, drawn as it draws them."""
    n, h, w, _ = shape
    k_flip, k_scale, k_cx, k_cy, k_b, k_c, k_s, k_n = jax.random.split(key, 8)
    out = dict.fromkeys(("flip", "scale", "cx", "cy", "brightness",
                         "contrast", "saturation", "noise"))
    if cfg.flip:
        out["flip"] = jax.random.bernoulli(k_flip, 0.5, (n,))
    lo, hi = cfg.scale
    if (lo, hi) != (1.0, 1.0):
        s = jax.random.uniform(k_scale, (n,), minval=lo, maxval=hi)
        slack_y = jnp.maximum((h - 1) * (1 - s) / 2.0, 0.0)
        slack_x = jnp.maximum((w - 1) * (1 - s) / 2.0, 0.0)
        out["scale"] = s
        out["cy"] = (h - 1) / 2.0 + jax.random.uniform(
            k_cy, (n,), minval=-1.0, maxval=1.0) * slack_y
        out["cx"] = (w - 1) / 2.0 + jax.random.uniform(
            k_cx, (n,), minval=-1.0, maxval=1.0) * slack_x
    if cfg.brightness > 0:
        out["brightness"] = jax.random.uniform(
            k_b, (n,), minval=-cfg.brightness, maxval=cfg.brightness)
    if cfg.contrast > 0:
        out["contrast"] = 1.0 + jax.random.uniform(
            k_c, (n,), minval=-cfg.contrast, maxval=cfg.contrast)
    if cfg.saturation > 0:
        out["saturation"] = 1.0 + jax.random.uniform(
            k_s, (n,), minval=-cfg.saturation, maxval=cfg.saturation)
    if cfg.noise_std > 0:
        out["noise"] = jax.random.normal(k_n, shape)
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in out.items()}


def batch(seed, n=3, hw=(24, 40)):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n,) + hw + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (n,) + hw).astype(np.int32)
    return images, labels


CONFIGS = {
    "default": {},
    "zoom_in": dict(scale=(0.5, 0.8)),
    "zoom_out": dict(scale=(1.3, 1.6), flip=False),
    "photometric": dict(scale=(1.0, 1.0), noise_std=0.0),
    "strong": dict(brightness=0.5, contrast=0.5, saturation=0.6,
                   noise_std=0.05),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_matches_jax_augment_batch(name, seed):
    kw = CONFIGS[name]
    jcfg, cfg = JAugmentConfig(**kw), AugmentConfig(**kw)
    images, labels = batch(seed)
    key = jax.random.PRNGKey(seed + 10)
    want_img, want_lbl = jax.jit(
        lambda k, x, y: jaugment(k, x, y, jcfg))(key, images, labels)
    got_img, got_lbl = apply_params(
        torch.from_numpy(images), torch.from_numpy(labels),
        jax_params(key, images.shape, jcfg), cfg)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    assert np.abs(got_img.numpy() - np.asarray(want_img)).max() <= IMAGE_ATOL
    assert got_img.dtype == torch.float32 and got_lbl.dtype == torch.int32


def test_config_defaults_are_jax():
    assert dataclasses.asdict(AugmentConfig()) == dataclasses.asdict(
        JAugmentConfig())


def test_draw_shapes_dtypes_and_determinism():
    images, labels = batch(2, n=4)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    a = augment_batch(torch.Generator().manual_seed(5), x, y)
    b = augment_batch(torch.Generator().manual_seed(5), x, y)
    c = augment_batch(torch.Generator().manual_seed(6), x, y)
    for out in (a, b, c):
        assert out[0].shape == x.shape and out[0].dtype == x.dtype
        assert out[1].shape == y.shape and out[1].dtype == y.dtype
        assert float(out[0].min()) >= 0.0 and float(out[0].max()) <= 1.0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    p = draw_params(torch.Generator().manual_seed(5), tuple(x.shape))
    assert p["flip"].dtype == torch.bool and p["noise"].shape == x.shape
    s = p["scale"]
    assert bool(((s >= 0.75) & (s <= 1.25)).all())
    with pytest.raises(ValueError, match="expected"):
        apply_params(x[0], y, p)


def test_identity_config_changes_nothing():
    cfg = AugmentConfig(flip=False, scale=(1.0, 1.0), brightness=0.0,
                        contrast=0.0, saturation=0.0, noise_std=0.0)
    images, labels = batch(3)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    gx, gy = augment_batch(torch.Generator().manual_seed(0), x, y, cfg)
    assert torch.equal(gx, x) and torch.equal(gy, y)


def test_zoom_out_fills_ignore_label():
    """Zoomed out (scale > 1) the view leaves the frame: those pixels get
    image 0 and ``ignore_label``, the centre keeps real labels."""
    cfg = AugmentConfig(flip=False, scale=(1.5, 1.5), brightness=0.0,
                        contrast=0.0, saturation=0.0, noise_std=0.0,
                        ignore_label=200)
    images, labels = batch(4)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    gx, gy = augment_batch(torch.Generator().manual_seed(0), x, y, cfg)
    assert bool((gy[:, 0, :] == 200).all()) and bool((gy[:, :, 0] == 200)
                                                      .all())
    assert bool((gx[:, 0, :] == 0).all())
    assert bool((gy[:, 12, 20] < 15).all())
