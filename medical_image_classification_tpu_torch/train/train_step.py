"""The train step.  Port of
``medical_image_classification_tpu/train/train_state.py``:
``cross_entropy_loss`` (``:55-61``) and ``make_train_step_fn`` (``:64-96``).

The JAX step is a pure function of a ``TrainState``; here the model and the
optimizer carry the parameters, the BatchNorm running stats and the
optimizer state, updated in place, and ``TrainState`` keeps what is left:
the step count and the best validation accuracy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)


@dataclasses.dataclass
class TrainState:
    step: int = 0
    best_acc: float = 0.0


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0):
    """Mean cross-entropy in fp32; with ``label_smoothing`` the one-hot
    target becomes (1 - s) onehot + s / classes."""
    num = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num).to(torch.float32)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(onehot * logp).sum(-1).mean()


def make_train_step(model, optimizer, scheduler=None,
                    label_smoothing: float = 0.0,
                    state: TrainState | None = None) -> Callable:
    """Returns (images_u8 [B, H, W, 3], labels [B]) -> {loss, accuracy}
    (0-d tensors on the batch's device, not synchronised).  One call runs
    the model in train mode (batch statistics, BatchNorm running stats
    updated, DropPath on), back-propagates, steps the optimizer and the
    learning-rate scheduler, and counts the step in ``state``."""

    def step_fn(images, labels):
        model.train()
        logits = model(normalize_batch(images))
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if state is not None:
            state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step_fn
