"""The port's fusion losses against the JAX package's
``train/fusion_losses.py``: ``ssim`` (with its cs term), ``msssim`` (the
reference's broadcast of the last level's SSIM into every cs term),
``sobel_grad``, ``rgb_to_y``, ``fusion_loss`` and its three parts, and the
segmentation losses, on seeded numpy images at 64x64 and at 32x32 (where
MS-SSIM's deeper levels shrink the 11-tap window to the image): values
within rtol 2e-4, atol 1e-5 (fp32: SSIM's variances are differences of
blurred squares, summed in another order; SSIM of noise reads ~0.08, off
by ~5e-5 relative) and the gradients with respect to the fused image (and
the inputs) within 1e-4 x max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.train import fusion_losses as jfl
from medical_image_classification_tpu_torch.train import fusion_losses as tfl

torch.set_num_threads(2)


def _images(side, seed, channels=1, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.random((batch, side, side, channels), dtype=np.float32)
            for _ in range(3)]


def _close(got, want, rtol=2e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _grad_close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("side", [64, 32, 16])
def test_ssim_and_msssim_match_jax(side):
    """At 16x16 MS-SSIM's fifth level is 1x1 (the JAX package pools once
    more, to an empty image it never reads)."""
    a, b, _ = _images(side, 0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ssim_j, cs_j = jfl.ssim(a, b, full=True)
    ssim_t, cs_t = tfl.ssim(ta, tb, full=True)
    _close(ssim_t, ssim_j)
    _close(cs_t, cs_j)
    _close(tfl.ssim(ta, tb, window_size=7, val_range=2.0),
           jfl.ssim(a, b, window_size=7, val_range=2.0))
    for normalize in (True, False):
        _close(tfl.msssim(ta, tb, normalize=normalize),
               jfl.msssim(a, b, normalize=normalize))


@pytest.mark.parametrize("side", [64, 32])
def test_sobel_and_luma_match_jax(side):
    a, _, _ = _images(side, 1)
    _close(tfl.sobel_grad(torch.from_numpy(a)), jfl.sobel_grad(a))
    rgb = _images(side, 2, channels=3)[0]
    _close(tfl.rgb_to_y(torch.from_numpy(rgb)), jfl.rgb_to_y(rgb))


@pytest.mark.parametrize("side,channels", [(64, 1), (32, 1), (32, 3)])
def test_fusion_loss_values_and_gradients_match_jax(side, channels):
    """The total and its three parts; the gradient of the total with
    respect to the fused image and to both inputs (3-channel inputs: the
    fusion trainer's; a 3-channel fused image takes its luma)."""
    vis, ir, _ = _images(side, 3, channels=3)
    gen = _images(side, 4, channels=channels)[0]
    # some pixels outside [0, 1], as a fused image before its clamp
    gen = 1.4 * gen - 0.2

    def total_j(v, i, g):
        return jfl.fusion_loss(v, i, g)[0]

    parts_j = jfl.fusion_loss(vis, ir, gen)
    grads_j = jax.grad(total_j, argnums=(0, 1, 2))(vis, ir, gen)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (vis, ir, gen)]
    parts_t = tfl.fusion_loss(*ins)
    for got, want in zip(parts_t, parts_j):
        _close(got.detach(), want)
    parts_t[0].backward()
    for t, want in zip(ins, grads_j):
        _grad_close(t.grad, want)


def test_msssim_gradient_matches_jax():
    a, b, _ = _images(64, 5)
    want = jax.grad(lambda x: jfl.msssim(x, b))(a)
    ta = torch.from_numpy(a).requires_grad_(True)
    tfl.msssim(ta, torch.from_numpy(b)).backward()
    _grad_close(ta.grad, want)


def test_segmentation_losses_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 16, 16, 1), dtype=np.float32) * 3
    targets = (rng.random((2, 16, 16, 1)) > 0.5).astype(np.float32)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    for name in ("bce_loss", "dice_loss", "ce_dice_loss"):
        _close(getattr(tfl, name)(tl, tt), getattr(jfl, name)(
            jnp.asarray(logits), jnp.asarray(targets)))
