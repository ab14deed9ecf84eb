"""The eval steps.  Port of
``medical_image_classification_tpu/train/train_state.py::make_eval_step``,
with the two-input models' steps (the cross classifiers', the fusion
U-Nets' as ``cli/fusion_test.py`` runs them)."""

from __future__ import annotations

from typing import Callable

import torch

from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)


def make_eval_step(model) -> Callable:
    """Returns (images_u8 [B, H, W, 3], labels [B]) -> (n_correct, logits),
    run under ``torch.inference_mode()`` with the model in eval mode."""

    def eval_fn(images, labels):
        model.eval()
        with torch.inference_mode():
            logits = model(normalize_batch(images))
            correct = (logits.argmax(-1) == labels).sum()
        return correct, logits

    return eval_fn


def make_cross_eval_step(model) -> Callable:
    """The cross classifiers' eval: (xa, xb float [B, H, W, 3], labels [B])
    -> (n_correct, logits), under ``torch.inference_mode()`` in eval mode."""

    def eval_fn(xa, xb, labels):
        model.eval()
        with torch.inference_mode():
            logits = model(xa, xb)
            correct = (logits.argmax(-1) == labels).sum()
        return correct, logits

    return eval_fn


def make_fusion_eval_step(model) -> Callable:
    """The fusion U-Nets' inference: (xa, xb) -> the fused image clamped to
    [0, 1], [B, H, W, 1] fp32, under ``torch.inference_mode()`` in eval
    mode."""

    def infer(xa, xb):
        model.eval()
        with torch.inference_mode():
            return model(xa, xb).clamp(0.0, 1.0)

    return infer
