"""Training CLI of the port.  Port of
``medical_image_classification_tpu/cli/train.py`` (single device).

  python -m medical_image_classification_tpu_torch.cli.train \
      --data-path /data/oct/train --model medmamba --epochs 100 \
      [--device cuda] [--resume runs/model.ckpt]

Each epoch trains, evaluates top-1 on the validation folder (``--val-path``,
default the sibling ``val`` of ``--data-path``) through ``cli/test.py::
run_eval``, writes ``<save-path>.best`` (the model's ``state_dict``) when
the accuracy improves, and the composite checkpoint under ``<save-path>/``.
``--resume <save-path>`` continues after the newest saved epoch.  Not
ported yet: data parallelism (``cli/ddp_train.py``), ``--tp``, ``--sp`` and
KAN grid updates.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from medical_image_classification_tpu_torch.cli.test import run_eval
from medical_image_classification_tpu_torch.data.image_folder import (
    dump_class_indices,
    scan_image_folder,
)
from medical_image_classification_tpu_torch.data.loader import BatchLoader
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_params_only,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    make_train_step,
)
from medical_image_classification_tpu_torch.utils.config import (
    TrainConfig,
    add_args,
    check_ported,
    from_args,
)

log = logging.getLogger("mic_torch")


def run_train(model, optimizer, scheduler, loader, device, epoch: int = 0,
              label_smoothing: float = 0.0, state: TrainState | None = None,
              log_every: int = 0):
    """Train on every batch of ``loader.epoch(epoch)``.

    Returns {loss, accuracy, steps, seconds, img_s}: loss and accuracy are
    means over the epoch's steps; seconds is the host clock over the epoch
    (data, copies and steps), ending in a synchronize on a CUDA device."""
    step = make_train_step(model, optimizer, scheduler, label_smoothing,
                           state)
    spe = loader.steps_per_epoch()
    losses, accs, n_images = [], [], 0
    t0 = time.perf_counter()
    for imgs, labels in loader.epoch(epoch):
        m = step(torch.from_numpy(imgs).to(device),
                 torch.from_numpy(np.asarray(labels, np.int64)).to(device))
        losses.append(m["loss"])
        accs.append(m["accuracy"])
        n_images += imgs.shape[0]
        if log_every and len(losses) % log_every == 0:
            log.info("epoch %d step %d/%d loss %.4f acc %.4f", epoch,
                     len(losses), spe, float(torch.stack(losses).mean()),
                     float(torch.stack(accs).mean()))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if not losses:
        raise ValueError("the loader gave no batch (fewer images than one "
                         "batch?)")
    return dict(loss=float(torch.stack(losses).mean()),
                accuracy=float(torch.stack(accs).mean()), steps=len(losses),
                seconds=seconds, img_s=n_images / max(seconds, 1e-9))


def main(cfg: TrainConfig) -> float:
    check_ported(cfg)
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    save_dir = os.path.dirname(cfg.save_path) or "."
    os.makedirs(save_dir, exist_ok=True)

    train_ds = scan_image_folder(cfg.data_path)
    val_path = cfg.val_path or os.path.join(
        os.path.dirname(cfg.data_path.rstrip("/")), "val")
    val_ds = scan_image_folder(val_path) if os.path.isdir(val_path) else None
    dump_class_indices(train_ds, os.path.join(save_dir, "class_indices.json"))
    log.info("train images: %d  classes: %s", len(train_ds), train_ds.classes)
    train_loader = BatchLoader(train_ds, cfg.batch_size, cfg.image_size,
                               train=True, seed=cfg.seed,
                               num_threads=cfg.num_workers)

    model = create_model(cfg.model, num_classes=cfg.num_classes,
                         use_checkpoint=cfg.use_checkpoint,
                         scan_impl=cfg.scan_impl,
                         generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    model.seed_drop_path(cfg.seed + 1)
    schedule = make_schedule(cfg.schedule, cfg.lr,
                             train_loader.steps_per_epoch(), cfg.epochs,
                             cfg.warmup_epochs)
    optimizer = make_optimizer(cfg.optimizer, model.named_parameters(),
                               cfg.weight_decay, grad_clip=cfg.grad_clip)
    scheduler = make_lr_scheduler(optimizer, schedule)
    state = TrainState()

    start_epoch = 0
    if cfg.resume:
        ep, best = restore_checkpoint(cfg.resume, model, optimizer,
                                      scheduler, state)
        start_epoch = ep + 1
        log.info("resumed from %s at epoch %d (best %.4f)", cfg.resume, ep,
                 best)

    for epoch in range(start_epoch, cfg.epochs):
        m = run_train(model, optimizer, scheduler, train_loader, device,
                      epoch, cfg.label_smoothing, state, cfg.log_every)
        log.info("epoch %d done: loss %.4f acc %.4f (%.1f img/s)", epoch,
                 m["loss"], m["accuracy"], m["img_s"])
        if val_ds is not None:
            val_loader = BatchLoader(val_ds, cfg.batch_size, cfg.image_size,
                                     train=False)
            n_correct, labels, _ = run_eval(model, val_loader, device)
            acc = n_correct / max(len(labels), 1)
            log.info("epoch %d val top-1: %.4f", epoch, acc)
            if acc > state.best_acc:
                state.best_acc = acc
                save_params_only(cfg.save_path + ".best", model)
        save_checkpoint(cfg.save_path, model, optimizer, scheduler, state,
                        epoch)
    log.info("training done; best val acc %.4f", state.best_acc)
    return state.best_acc


def parse_args(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(description=__doc__)
    add_args(p, TrainConfig())
    return from_args(TrainConfig, p.parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
