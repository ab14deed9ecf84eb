"""Count the forward and train-step FLOPs per image of the benched
configurations, the port's own count (``utils/flops.py``).

Port of the JAX package's ``scripts/flops_report.py``: the same seven
``CONFIGS`` (model, batch, size, dtype), and vfefm_2c1 and fusionmamba,
which the JAX script does not count.  Each count runs on fake tensors on
``--device`` (the card's dispatch by default; nothing computes), so a
full-size model counts in seconds: the forward in eval mode, and the train
step's forward in train mode and its backward, of the loss each trainer
takes (cross-entropy; the fusion loss of the clamped fused image).  FLOPs
are FlopCounterMode's, two a multiply-add, the hand kernels by their
formulas; elementwise work and the optimizer count nothing (XLA's count in
``FLOPS.json`` includes them, and counted the JAX einsum path).  Writes one
JSON object, FLOPS.json's layout, to ``--out`` or to stdout; it never
writes ``FLOPS.json``.

    python -m medical_image_classification_tpu_torch.scripts.flops_report \\
        [KEY ...] [--out FILE.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.cli.fusion_train import device_of
from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.models.registry import (
    create_fusion_model,
)
from medical_image_classification_tpu_torch.train.fusion_losses import (
    fusion_loss,
)
from medical_image_classification_tpu_torch.utils.flops import (
    model_flops,
    train_flops,
)

# key -> (kind, model name, batch, size, dtype): the JAX script's seven,
# then the two U-Nets it does not count, at their trainer's defaults
CONFIGS = {
    "medmamba": ("cls", "medmamba", 32, 224, "bf16"),
    "medssd": ("cls", "medssd", 32, 224, "bf16"),
    "st_ssd": ("cls", "st_ssd", 8, 224, "bf16"),
    "medssd_ekan": ("cls", "medssd_ekan", 16, 224, "bf16"),
    "cross_cls_stage3": ("cross", "cross_cls_stage3", 8, 224, "bf16"),
    "vfefm_2b2_bf16": ("fusion", "vfefm_2b2", 2, 256, "bf16"),
    "vfefm_2b2": ("fusion", "vfefm_2b2", 2, 256, "fp32"),
    "vfefm_2c1": ("fusion", "vfefm_2c1", 2, 256, "fp32"),
    "fusionmamba": ("fusion", "fusionmamba", 2, 256, "fp32"),
}
CLASSES = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("only", nargs="*", help="keys of CONFIGS (default all)")
    p.add_argument("--out", default="", help="JSON file (default stdout)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _ce(labels):
    """Cross-entropy of logits against ``labels``, the one-hot made here,
    outside the count (a one-hot reads the labels' values)."""
    onehot = F.one_hot(labels, CLASSES).float()
    return lambda logits, *inputs: -(
        onehot * F.log_softmax(logits.float(), -1)).sum(-1).mean()


def _fusion(out, xa, xb):
    return fusion_loss(xa, xb, out.clamp(0.0, 1.0))[0]


def count(kind: str, name: str, batch: int, size: int, dtype: str,
          device) -> tuple:
    """(forward FLOPs, train-step FLOPs) of one configuration."""
    kw = {"dtype": torch.bfloat16} if dtype == "bf16" else {}
    gen = torch.Generator().manual_seed(0)
    labels = torch.arange(batch) % CLASSES
    if kind == "cls":
        model = create_model(name, CLASSES, generator=gen, **kw)
        imgs = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (batch, size, size, 3), dtype=np.uint8))
        inputs, loss = (normalize_batch(imgs),), _ce(labels)
    else:
        if kind == "cross":
            kw["num_classes"] = CLASSES
        model = create_fusion_model(name, generator=gen, **kw)
        channels = 1 if name == "fusionmamba" else 3
        inputs = tuple(torch.from_numpy(np.random.RandomState(s).rand(
            batch, size, size, channels).astype(np.float32))
            for s in (0, 1))
        loss = _ce(labels) if kind == "cross" else _fusion
    model = model.to(device)
    inputs = tuple(t.to(device) for t in inputs)
    fwd = model_flops(model, inputs)
    step = train_flops(model, inputs, loss)
    if fwd is None or step is None:
        raise RuntimeError(f"{name}: the FLOP count failed")
    return fwd, step


def main(args) -> dict:
    """Returns {key: FLOPS.json's record}, having written it."""
    device = device_of(args)
    out = {}
    for key, (kind, name, batch, size, dtype) in CONFIGS.items():
        if args.only and key not in args.only:
            continue
        fwd, step = count(kind, name, batch, size, dtype, device)
        out[key] = {
            "model": name, "batch": batch, "size": size, "dtype": dtype,
            "fwd_flops": fwd, "step_flops": step,
            "fwd_flops_per_image": fwd / batch,
            "step_flops_per_image": step / batch,
        }
        print(f"{key}: fwd {fwd / batch / 1e9:.2f} GF/img, "
              f"step {step / batch / 1e9:.2f} GF/img", file=sys.stderr)
    text = json.dumps(out, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return out


if __name__ == "__main__":
    main(parse_args())
