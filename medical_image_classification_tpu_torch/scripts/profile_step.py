"""Trace a few train steps of a registry classifier and print the device
time by category, source line and kernel (``utils/profiling.py``).

Port of the JAX package's ``scripts/profile_step.py``, with its options:
the seeded model (8 classes) through ``train/train_step.py``'s step with
Adam at lr 1e-4 on one batch of random uint8 images, two warm-up steps,
then ``--steps`` steps inside ``profiling.trace``, summarised by
``profiling.summarize_trace`` as ms a step.  Runs on the card unless
``--device cpu`` is given (a CPU trace counts the ops' self time).

    python -m medical_image_classification_tpu_torch.scripts.profile_step \\
        [--model medmamba] [--batch 32] [--size 224] [--steps 3] \\
        [--dtype bf16] [--logdir runs/profile_step] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from medical_image_classification_tpu_torch.cli.fusion_train import device_of
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    make_train_step,
)
from medical_image_classification_tpu_torch.utils import profiling

DTYPES = {"bf16": torch.bfloat16, "fp32": None}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="medmamba")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    p.add_argument("--logdir", default="runs/profile_step")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(args) -> dict:
    """Returns ``summarize_trace``'s result, having printed it."""
    device = device_of(args)
    dt = DTYPES[args.dtype]
    model = create_model(args.model, 8, generator=torch.Generator()
                         .manual_seed(0),
                         **({"dtype": dt} if dt is not None else {}))
    model = model.to(device)
    imgs = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (args.batch, args.size, args.size, 3), dtype=np.uint8))
    imgs = imgs.to(device)
    labels = (torch.arange(args.batch) % 8).to(device)
    opt = make_optimizer("adam", model.named_parameters())
    step = make_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)))
    for _ in range(2):                      # warm-up
        step(imgs, labels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profiling.trace(args.logdir):
        for _ in range(args.steps):
            step(imgs, labels)
    summary = profiling.summarize_trace(args.logdir, steps=args.steps)
    profiling.print_trace_summary(summary)
    return summary


if __name__ == "__main__":
    main(parse_args())
