"""Grad-CAM of the VSSM classifiers, by ``torch.autograd.grad`` of the
target logits with respect to the stage activations.

Port of ``medical_image_classification_tpu/evaluate/gradcam.py``: for each
targeted stage, CAM = minmax(ReLU(sum_c GAP_spatial(dS/dA)_c A_c)),
resized to the input (bilinear, half-pixel centres) and min-max scaled per
image; the stages' maps are averaged and the mean min-max scaled again.
S is the sum over the batch of each image's target logit.

The stage activations come from ``VSSM.stage_outputs`` (hooks at each
stage's output, before its PatchMerging).  The model runs in eval mode
(BatchNorm on its running statistics, DropPath off) with autograd on and
outside inference mode: the reference computed CAM under
``torch.no_grad()``, which silently zeroed its hooks.  So the forward
kernels run, then the backward kernels of every stage after the first one
targeted.  No parameter or buffer changes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)


def stage_grads(model, images_u8, targets=None,
                stages: Optional[Sequence[str]] = None):
    """One forward and one ``torch.autograd.grad`` on the model's device.

    images_u8 [B, H, W, 3] uint8 (numpy or torch); targets [B] or None (the
    argmax).  Returns (acts, grads, targets): the activations of each stage
    named in ``stages`` (default: all, ``VSSM.stage_names``) and the
    gradients of S with respect to them, {name: [B, h, w, C]} in the
    model's compute dtype, and the targets [B] (long), all on the device.
    """
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(False), torch.enable_grad(), \
                model.stage_outputs(stages) as acts:
            x = normalize_batch(torch.as_tensor(images_u8).to(device))
            logits = model(x)
            if targets is None:
                targets = logits.argmax(-1)
            targets = torch.as_tensor(targets, device=device).long()
            score = logits[torch.arange(x.shape[0], device=device),
                           targets].sum()
            names = list(acts) if stages is None else list(stages)
            grads = torch.autograd.grad(score, [acts[n] for n in names])
    finally:
        model.train(was_training)
    return ({n: acts[n].detach() for n in names}, dict(zip(names, grads)),
            targets)


def resize_bilinear(cam, size):
    """[B, h, w] -> [B, H, W] fp32: the triangle kernel at half-pixel
    centres, taps outside the map dropped and the rest renormalized, as
    ``jax.image.resize(..., method="bilinear")`` does when it enlarges."""
    return F.interpolate(cam[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def _minmax(t):
    mn = t.amin(dim=(1, 2), keepdim=True)
    mx = t.amax(dim=(1, 2), keepdim=True)
    return (t - mn) / torch.clamp(mx - mn, min=1e-7)


def stage_cam(act, grad):
    """ReLU(sum_c mean_hw(grad)_c act_c) in fp32: [B, h, w, C] -> [B, h, w]."""
    wgt = grad.float().mean(dim=(1, 2), keepdim=True)
    return torch.relu((wgt * act.float()).sum(-1))


def grad_cam(model, images_u8, targets=None,
             stages: Optional[Sequence[str]] = None) -> np.ndarray:
    """Grad-CAM heatmaps: float32 [B, H, W] in [0, 1] (see the module
    docstring); ``images_u8``, ``targets`` and ``stages`` as in
    ``stage_grads``."""
    acts, grads, _ = stage_grads(model, images_u8, targets, stages)
    H, W = np.shape(images_u8)[1:3]
    cams = [_minmax(resize_bilinear(stage_cam(acts[n], grads[n]), (H, W)))
            for n in acts]
    return _minmax(torch.stack(cams).mean(0)).cpu().numpy()


def overlay_heatmap(image_u8: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.4) -> np.ndarray:
    """Blend an [H, W] map in [0, 1] onto an RGB uint8 image through
    OpenCV's JET colour map."""
    import cv2
    heat = cv2.applyColorMap((cam * 255).astype(np.uint8), cv2.COLORMAP_JET)
    heat = heat[:, :, ::-1]                              # BGR -> RGB
    out = (1 - alpha) * image_u8.astype(np.float32) + alpha * heat
    return np.clip(out, 0, 255).astype(np.uint8)
