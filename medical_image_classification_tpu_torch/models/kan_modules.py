"""Classifier heads.  Port of
``medical_image_classification_tpu/models/kan_modules.py::ClassifierHead``,
``kind="linear"`` only so far."""

from __future__ import annotations

import torch.nn as nn


class ClassifierHead(nn.Linear):
    """The linear head (a Linear, so its state_dict keys are the
    reference's ``head.weight`` / ``head.bias``)."""

    def __init__(self, in_features: int, num_classes: int,
                 kind: str = "linear"):
        if kind != "linear":
            raise NotImplementedError(
                f"head kind {kind!r} is not ported yet (ROADMAP.md Queue 1, "
                "item 8: the SSD-family zoo and its KAN heads)")
        super().__init__(in_features, num_classes)
