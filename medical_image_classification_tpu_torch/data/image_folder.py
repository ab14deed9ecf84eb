"""ImageFolder dataset of the port: the class scan, OpenCV decode with the
train and eval transforms, and input normalisation on the device.

A copy of ``medical_image_classification_tpu/data/image_folder.py`` (same
directory contract root/class_x/img.png, classes sorted by name, the same
``class_indices.json``, the same crop sampling), kept here so that the
port imports nothing of the JAX package.  ``normalize_batch`` is the torch
version of the JAX helper.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


@dataclass
class ImageFolder:
    root: str
    samples: List[Tuple[str, int]]
    classes: List[str]

    @property
    def class_to_idx(self):
        return {c: i for i, c in enumerate(self.classes)}

    def __len__(self):
        return len(self.samples)


def scan_image_folder(root: str) -> ImageFolder:
    """Deterministic scan: classes sorted by name (torchvision contract)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        for dirpath, _, files in sorted(os.walk(os.path.join(root, cls))):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, f), idx))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")
    return ImageFolder(root=root, samples=samples, classes=classes)


def dump_class_indices(ds: ImageFolder, path: str = "class_indices.json"):
    """Write {index: class_name}, as the reference trainer does."""
    mapping = {str(i): c for i, c in enumerate(ds.classes)}
    with open(path, "w") as f:
        json.dump(mapping, f, indent=4)
    return mapping


def _decode(path: str) -> np.ndarray:
    """RGB uint8 HWC; grayscale is replicated to 3 channels."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)            # BGR
    if img is None:                                      # exotic formats
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGB"))[:, :, ::-1]
    return img[:, :, ::-1]


def load_train_image(path: str, size: int, rng: np.random.Generator,
                     scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """RandomResizedCrop(size) (torchvision's sampling, bilinear resize)
    and a random horizontal flip.  Returns uint8 HWC RGB."""
    import cv2
    img = _decode(path)
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.integers(0, h - ch + 1)
            j = rng.integers(0, w - cw + 1)
            crop = img[i:i + ch, j:j + cw]
            break
    else:                                                # center crop
        s = min(h, w)
        i, j = (h - s) // 2, (w - s) // 2
        crop = img[i:i + s, j:j + s]
    out = cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


def load_eval_image(path: str, size: int) -> np.ndarray:
    """Resize(size, size), bilinear.  Returns uint8 HWC RGB."""
    import cv2
    return cv2.resize(_decode(path), (size, size),
                      interpolation=cv2.INTER_LINEAR)


def normalize_batch(x, mean: float = 0.5, std: float = 0.5):
    """uint8 [B, H, W, 3] -> fp32, (x / 255 - mean) / std."""
    return (x.to(torch.float32) / 255.0 - mean) / std
