"""Host-side batch loaders of the port.

``BatchLoader`` is a copy of the OpenCV path of
``medical_image_classification_tpu/data/loader.py::BatchLoader`` (the same
epoch-seeded shuffle and per-image augmentation seeds, threads for decode,
a small prefetch queue); the native C++ decoder is not carried over.
``SyntheticLoader`` gives seeded random batches with no disk, the same
stream as the JAX package's.  Both are kept here so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from medical_image_classification_tpu_torch.data.image_folder import (
    ImageFolder,
    load_eval_image,
    load_train_image,
)


class BatchLoader:
    """Deterministic, epoch-seeded, prefetching loader of an ImageFolder.

    Each epoch shuffles with (seed, epoch) in train mode; each image's
    augmentation draws from (seed, epoch, batch, index).  Yields
    (images uint8 [B, H, W, 3], labels int32 [B])."""

    def __init__(self, dataset: ImageFolder, batch_size: int, image_size: int,
                 train: bool, seed: int = 0, num_threads: int = 8,
                 prefetch: int = 4, drop_last: Optional[bool] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = train if drop_last is None else drop_last

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.train:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def steps_per_epoch(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _load_one(self, sample_idx: int, seed) -> Tuple[np.ndarray, int]:
        path, label = self.ds.samples[sample_idx]
        if self.train:
            img = load_train_image(path, self.image_size,
                                   np.random.default_rng(seed))
        else:
            img = load_eval_image(path, self.image_size)
        return img, label

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray,
                                                      np.ndarray]]:
        idx = self._epoch_indices(epoch)
        nb = self.steps_per_epoch()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for b in range(nb):
                    if stop.is_set():
                        return
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    seeds = [(self.seed, epoch, b, int(s)) for s in sel]
                    imgs = np.empty((len(sel), self.image_size,
                                     self.image_size, 3), dtype=np.uint8)
                    labels = np.empty((len(sel),), dtype=np.int32)
                    done = pool.map(self._load_one, sel, seeds)
                    for i, (img, label) in enumerate(done):
                        imgs[i], labels[i] = img, label
                    out_q.put((imgs, labels))
            out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()


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
