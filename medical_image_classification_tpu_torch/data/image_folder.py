"""Input normalisation on the device.  The ImageFolder scan and the loaders
are the JAX package's numpy/C++ ``data`` pipeline, used as they are."""

from __future__ import annotations

import torch


def normalize_batch(x, mean: float = 0.5, std: float = 0.5):
    """uint8 [B, H, W, 3] -> fp32, (x / 255 - mean) / std."""
    return (x.to(torch.float32) / 255.0 - mean) / std
