"""CT/MRI fusion training CLI of the port.  Port of
``medical_image_classification_tpu/cli/fusion_train.py``.

  python -m medical_image_classification_tpu_torch.cli.fusion_train \
      --data-path /data/CT_MRI --epochs 100 --batch-size 2 \
      [--single-decoder | --model fusionmamba] [--dtype bf16] \
      [--device cuda]

The defaults are the reference's: batch 2, Adam 2e-4 with the learning
rate times 0.75 each epoch, 256x256 pairs repeated to 3 channels, the fused
image clamped to [0, 1], fp32 compute.  ``--single-decoder`` trains the
``_2c1`` variant (``vfefm_2c1``); ``--model fusionmamba`` the FusionMamba
U-Net on one-channel pairs (d_state 16 unless ``--d-state`` is given;
``--headdim``, ``--cat-method`` and ``--single-decoder`` do not apply to
it and are ignored); ``--depths`` / ``--dims`` set the encoder and,
reversed, the decoder.  After each epoch the model's ``state_dict`` is
written to ``--save-path`` (``cli/fusion_test.py --weights`` loads a vfefm
one).  It runs on the card unless ``--device cpu`` is given, and raises
without one.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from medical_image_classification_tpu_torch.data.fusion_dataset import (
    FusionLoader,
    scan_fusion_pairs,
)
from medical_image_classification_tpu_torch.models import create_fusion_model
from medical_image_classification_tpu_torch.train.checkpoint import (
    save_params_only,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    make_fusion_train_step,
)

log = logging.getLogger("mic_torch")


def device_of(args) -> torch.device:
    """``--device``; a CUDA device must exist (nothing falls back to the
    CPU)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    return device


def model_kwargs(args) -> dict:
    """The U-Net's settings from the command line (shared with
    ``cli/fusion_test.py``, which has no ``--model``: vfefm)."""
    if getattr(args, "model", "vfefm") == "fusionmamba":
        kw = dict(d_state=args.d_state or 16)
    else:
        kw = dict(d_state=args.d_state or 128, cat_method=args.cat_method)
        if args.headdim:
            kw["ssd_headdim"] = args.headdim
    if args.depths:
        kw["depths"] = tuple(int(v) for v in args.depths.split(","))
        kw["depths_decoder"] = kw["depths"][::-1]
    if args.dims:
        kw["dims"] = tuple(int(v) for v in args.dims.split(","))
        kw["dims_decoder"] = kw["dims"][::-1]
    if getattr(args, "dtype", "fp32") == "bf16":
        kw["dtype"] = torch.bfloat16        # params stay fp32, image fp32
    return kw


def build_model(args, generator=None):
    """The fusion model ``args`` name (``--model``, ``--single-decoder``)."""
    if args.model == "fusionmamba":
        name = "fusionmamba"
    else:
        name = "vfefm_2c1" if args.single_decoder else "vfefm_2b2"
    return create_fusion_model(name, generator=generator,
                               **model_kwargs(args))


def run_fusion_train(model, optimizer, scheduler, loader, device,
                     epoch: int = 0, state: TrainState | None = None,
                     log_every: int = 0):
    """Train on every pair batch of ``loader.epoch(epoch)``.  Returns
    {loss, in, ssim, grad: per-step floats, steps, seconds, pairs_s}:
    seconds is the host clock over the epoch (data, copies and steps),
    ending in a synchronize on a CUDA device."""
    step = make_fusion_train_step(model, optimizer, scheduler, state)
    metrics, n_pairs = [], 0
    t0 = time.perf_counter()
    for xa, xb in loader.epoch(epoch):
        m = step(torch.from_numpy(xa).to(device),
                 torch.from_numpy(xb).to(device))
        metrics.append(m)
        n_pairs += xa.shape[0]
        if log_every and len(metrics) % log_every == 0:
            log.info("ep %d step %d loss %.4f (in %.4f ssim %.4f grad %.4f)",
                     epoch, len(metrics), *(float(m[k]) for k in
                                            ("loss", "in", "ssim", "grad")))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if not metrics:
        raise ValueError("the loader gave no batch (fewer pairs than one "
                         "batch?)")
    out = {k: torch.stack([m[k] for m in metrics]).tolist()
           for k in ("loss", "in", "ssim", "grad")}
    return dict(out, steps=len(metrics), seconds=seconds,
                pairs_s=n_pairs / max(seconds, 1e-9))


def main(args):
    """Train; returns (model, [each epoch's run_fusion_train result])."""
    device = device_of(args)
    model = build_model(args, torch.Generator().manual_seed(args.seed))
    pairs = scan_fusion_pairs(args.data_path, args.dir_a, args.dir_b,
                              length=args.max_pairs)
    loader = FusionLoader(pairs, args.batch_size, args.image_size,
                          channels=1 if args.model == "fusionmamba" else 3,
                          seed=args.seed)
    spe = loader.steps_per_epoch()
    log.info("%d pairs, %d steps/epoch", len(pairs), spe)
    model = model.to(device)
    model.seed_drop_path(args.seed + 1)
    optimizer = make_optimizer("adam", model.named_parameters())
    scheduler = make_lr_scheduler(optimizer, make_schedule(
        "fusion_exp", args.lr, spe, args.epochs, decay=args.lr_decay))
    state = TrainState()
    epochs = []
    for epoch in range(args.epochs):
        m = run_fusion_train(model, optimizer, scheduler, loader, device,
                             epoch, state, args.log_every)
        epochs.append(m)
        log.info("epoch %d done in %.1fs (%.2f pairs/s), mean loss %.4f",
                 epoch, m["seconds"], m["pairs_s"],
                 sum(m["loss"]) / m["steps"])
        save_params_only(args.save_path, model)
    log.info("saved %s", args.save_path)
    return model, epochs


def add_model_args(p: argparse.ArgumentParser):
    """The options that fix the U-Net, shared with ``cli/fusion_test.py``."""
    p.add_argument("--d-state", type=int, default=None,
                   help="default: 128 (fusionmamba: 16)")
    p.add_argument("--cat-method", default="stack",
                   choices=["stack", "add", "none"])
    p.add_argument("--single-decoder", action="store_true")
    p.add_argument("--depths", default=None, help="comma ints, e.g. 2,2,4,2")
    p.add_argument("--dims", default=None,
                   help="comma ints, e.g. 128,256,512,1024")
    p.add_argument("--headdim", type=int, default=None)
    p.add_argument("--device", default="cuda")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--dir-a", default="CT")
    p.add_argument("--dir-b", default="MRI")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-decay", type=float, default=0.75)
    p.add_argument("--model", default="vfefm",
                   choices=["vfefm", "fusionmamba"])
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="compute dtype (the reference trains fp32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-path", default="runs/fusion.pt")
    add_model_args(p)
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
