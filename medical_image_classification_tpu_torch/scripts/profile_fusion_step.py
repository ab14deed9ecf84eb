"""Trace a few train steps of a fusion U-Net and print the device time by
category, source line and kernel (``utils/profiling.py``).

Port of the JAX package's ``scripts/profile_fusion_step.py``, with its
options: the seeded model through ``train/train_step.py``'s
``make_fusion_train_step`` (the fused image clamped to [0, 1], the fusion
loss, Adam at lr 2e-4) on one pair of random images in [0, 1] (one channel
for fusionmamba, three for the vfefm U-Nets), two warm-up steps, then
``--steps`` steps inside ``profiling.trace``.  The defaults are the JAX
script's: vfefm_2b2, batch 2, 256x256, fp32.  Runs on the card unless
``--device cpu`` is given.

    python -m medical_image_classification_tpu_torch.scripts.profile_fusion_step \\
        [--model vfefm_2b2] [--batch 2] [--size 256] [--steps 3] \\
        [--dtype fp32] [--logdir runs/profile_fusion_step] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from medical_image_classification_tpu_torch.cli.fusion_train import device_of
from medical_image_classification_tpu_torch.models.registry import (
    create_fusion_model,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    make_fusion_train_step,
)
from medical_image_classification_tpu_torch.utils import profiling


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="vfefm_2b2")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--logdir", default="runs/profile_fusion_step")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def pair(batch: int, size: int, channels: int, device):
    """The JAX script's pair: uniform [0, 1) images from seeds 0 and 1."""
    return tuple(torch.from_numpy(np.random.RandomState(seed).rand(
        batch, size, size, channels).astype(np.float32)).to(device)
        for seed in (0, 1))


def main(args) -> dict:
    """Returns ``summarize_trace``'s result, having printed it."""
    device = device_of(args)
    channels = 1 if args.model == "fusionmamba" else 3
    kw = {"dtype": torch.bfloat16} if args.dtype == "bf16" else {}
    model = create_fusion_model(args.model, generator=torch.Generator()
                                .manual_seed(0), **kw).to(device)
    xa, xb = pair(args.batch, args.size, channels, device)
    opt = make_optimizer("adam", model.named_parameters())
    step = make_fusion_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 2e-4)))
    for _ in range(2):                      # warm-up
        step(xa, xb)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profiling.trace(args.logdir):
        for _ in range(args.steps):
            step(xa, xb)
    summary = profiling.summarize_trace(args.logdir, steps=args.steps)
    profiling.print_trace_summary(summary, top=20)
    return summary


if __name__ == "__main__":
    main(parse_args())
