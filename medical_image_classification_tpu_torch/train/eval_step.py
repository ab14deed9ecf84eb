"""The eval step.  Port of
``medical_image_classification_tpu/train/train_state.py::make_eval_step``."""

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
