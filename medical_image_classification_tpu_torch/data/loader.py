"""Synthetic batches for benchmarks and smoke runs.

Same class and stream as ``medical_image_classification_tpu/data/loader.py``
``SyntheticLoader``, kept here so that the port's main path (model, eval
step, ``run_eval``) imports nothing of the JAX package.  ImageFolder runs
use the JAX package's numpy/C++ ``BatchLoader``, imported by the CLI.
"""

from __future__ import annotations

import numpy as np


class SyntheticLoader:
    """Fixed-shape random uint8 batches from ``seed`` (no disk)."""

    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 steps: int = 16, seed: int = 0):
        self.batch_size, self.image_size = batch_size, image_size
        self.num_classes, self.steps, self.seed = num_classes, steps, seed

    def steps_per_epoch(self):
        return self.steps

    def epoch(self, epoch: int = 0):
        rng = np.random.default_rng((self.seed, epoch))
        for _ in range(self.steps):
            imgs = rng.integers(0, 256, (self.batch_size, self.image_size,
                                         self.image_size, 3), dtype=np.uint8)
            labels = rng.integers(0, self.num_classes,
                                  (self.batch_size,), dtype=np.int32)
            yield imgs, labels
