"""CT/MRI fusion pairs and the RGB / YCrCb colour tools.

A copy of ``medical_image_classification_tpu/data/fusion_dataset.py``
(kept here so that the port imports nothing of the JAX package): pairs
collected recursively under root/{dir_a} and root/{dir_b}, each image read
as grayscale, bicubic-resized, scaled to [0, 1] and repeated to 3 channels
where asked; ``FusionLoader`` shuffles each epoch with
``np.random.default_rng((seed, epoch))``, so its batches are the JAX
package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from medical_image_classification_tpu_torch.data.image_folder import (
    IMG_EXTENSIONS,
)


def _collect(root: str) -> List[str]:
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, f))
    return out


@dataclass
class FusionPairs:
    """Paired modalities: root/{dir_a}/x.png <-> root/{dir_b}/x.png, the
    pairs in sorted order."""
    a_paths: List[str]
    b_paths: List[str]

    def __len__(self):
        return len(self.a_paths)


def scan_fusion_pairs(root: str, dir_a: str = "CT", dir_b: str = "MRI",
                      length: Optional[int] = None) -> FusionPairs:
    """The first min(|a|, |b|) pairs (at most ``length``)."""
    a = _collect(os.path.join(root, dir_a))
    b = _collect(os.path.join(root, dir_b))
    if not a or not b:
        raise FileNotFoundError(f"no pairs under {root}/{dir_a}|{dir_b}")
    n = min(len(a), len(b))
    if length is not None:
        n = min(n, length)
    return FusionPairs(a[:n], b[:n])


def load_fusion_image(path: str, size: int = 256,
                      channels: int = 1) -> np.ndarray:
    """Grayscale read, bicubic resize to size x size, float32 in [0, 1],
    HWC with ``channels`` (1, or 3 repeated)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
    img = (img.astype(np.float32) / 255.0)[..., None]
    if channels == 3:
        img = np.repeat(img, 3, axis=-1)
    return img


class FusionLoader:
    """Batches of pairs (xa, xb), each float32 [B, size, size, channels],
    shuffled each epoch (the JAX loader's ``shuffle``, which every caller
    leaves on); the last short batch is dropped."""

    def __init__(self, pairs: FusionPairs, batch_size: int, size: int = 256,
                 channels: int = 3, seed: int = 0):
        self.pairs, self.batch_size = pairs, batch_size
        self.size, self.channels = size, channels
        self.seed = seed

    def steps_per_epoch(self):
        return len(self.pairs) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray,
                                                      np.ndarray]]:
        idx = np.arange(len(self.pairs))
        np.random.default_rng((self.seed, epoch)).shuffle(idx)
        for b in range(self.steps_per_epoch()):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            load = lambda paths: np.stack([load_fusion_image(
                paths[i], self.size, self.channels) for i in sel])
            yield load(self.pairs.a_paths), load(self.pairs.b_paths)


# --- colour tools -------------------------------------------------------------

def rgb_to_ycrcb(rgb: np.ndarray):
    """float [0, 1] HWC RGB -> (Y, Cr, Cb), each in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 0.5
    cb = (b - y) * 0.564 + 0.5
    return y, cr, cb


def ycrcb_to_rgb(y: np.ndarray, cr: np.ndarray, cb: np.ndarray):
    """The inverse of ``rgb_to_ycrcb``, clipped to [0, 1]."""
    r = y + 1.403 * (cr - 0.5)
    g = y - 0.714 * (cr - 0.5) - 0.344 * (cb - 0.5)
    b = y + 1.773 * (cb - 0.5)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def recombine_fused_y(fused_y: np.ndarray,
                      original_rgb: np.ndarray) -> np.ndarray:
    """An RGB image with its Y replaced by ``fused_y`` (bicubic-resized to
    the original), its CrCb kept."""
    import cv2
    h, w = original_rgb.shape[:2]
    fy = cv2.resize(fused_y, (w, h), interpolation=cv2.INTER_CUBIC)
    _, cr, cb = rgb_to_ycrcb(original_rgb)
    return ycrcb_to_rgb(fy, cr, cb)
