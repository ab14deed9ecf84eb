"""Training CLI of the port.  Port of
``medical_image_classification_tpu/cli/train.py`` (single device).

  python -m medical_image_classification_tpu_torch.cli.train \
      --data-path /data/oct/train --model medmamba --epochs 100 \
      [--device cuda] [--resume runs/model.ckpt]

Each epoch trains, evaluates top-1 on the validation folder (``--val-path``,
default the sibling ``val`` of ``--data-path``) through ``cli/test.py::
run_eval``, writes ``<save-path>.best`` (the model's ``state_dict``) when
the accuracy improves, and the composite checkpoint under ``<save-path>/``.
``--resume <save-path>`` continues after the newest saved epoch.

``--kan-update-grid-every N`` re-grids a KAN model every N epochs, after
the epoch's training and before its evaluation, on the first batch of the
epoch (``train/train_step.py::kan_grid_update``): the ekan and okan heads
re-fit their grids and spline weights in place, in eval mode, so no
BatchNorm stat moves and Adam's state stays with its parameters; the grids
are buffers, saved in the checkpoint and restored by ``--resume``.  The
other heads and the in-block KANs take no re-grid, as in the JAX package.

Parallel training (the JAX CLI's mesh): launched under torchrun, every
process is a rank of a (dp, tp, sp) mesh over the job (``parallel/
mesh.py``; ``--dist-backend`` nccl by default, one rank a GPU, or gloo).
Each rank trains on ``--batch-size`` // dp images a step, its data rank's
strided shard of every global batch (the seq ranks of one data rank read
the same shard); the gradients are averaged and the BatchNorm statistics
summed over the data axis, so a step is one process's step on the global
batch.  ``--sp N`` L-shards every SS2D scan over N ranks
(``parallel/sequence_parallel.py``; every stage's L must divide by N).
``--tp N`` splits every SS2D / SS2DSSD layer's d_inner channels, or
heads, over N ranks (tensor parallelism, ``parallel/sharding.py``; N must
divide every stage's d_inner and heads): the model is initialised at full
width from ``--seed`` and each rank keeps its pieces, so a run starts from
the weights a one-process run starts from, and the checkpoints hold the
full model.  The tp ranks of one data rank read the same shard.  Every
rank evaluates the whole validation set with the same weights; rank
0's count of correct images decides, rank 0 alone logs and writes the
checkpoints, and every rank waits for each write.

  torchrun --nproc-per-node 2 -m \
      medical_image_classification_tpu_torch.cli.train \
      --data-path /data/oct/train --sp 2    # or --tp 2, or 4 ranks: both
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
from medical_image_classification_tpu_torch.parallel.mesh import (
    init_process_group,
    is_main_process,
    main_process_value,
    make_mesh,
    set_current_mesh,
)
from medical_image_classification_tpu_torch.train.checkpoint import (
    load_full_state_dict,
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
    has_kan_grids,
    kan_grid_update,
    make_train_step,
)
from medical_image_classification_tpu_torch.utils.config import (
    TrainConfig,
    add_args,
    from_args,
)
from medical_image_classification_tpu_torch.utils.logging_utils import (
    get_logger,
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
    device = init_process_group(cfg.dist_backend, cfg.device)
    mesh = make_mesh(tp=cfg.tp, sp=cfg.sp, batch_size=cfg.batch_size)
    try:
        return _train(cfg, device, mesh)
    finally:
        set_current_mesh(None)


def _train(cfg: TrainConfig, device, mesh) -> float:
    save_dir = os.path.dirname(cfg.save_path) or "."
    get_logger("mic_torch", os.path.join(save_dir, "train.log"))
    log.info("device %s, mesh %s", device, mesh.shape)
    local_bs = cfg.batch_size // mesh.dp

    train_ds = scan_image_folder(cfg.data_path)
    val_path = cfg.val_path or os.path.join(
        os.path.dirname(cfg.data_path.rstrip("/")), "val")
    val_ds = scan_image_folder(val_path) if os.path.isdir(val_path) else None
    if is_main_process():
        os.makedirs(save_dir, exist_ok=True)
        dump_class_indices(train_ds,
                           os.path.join(save_dir, "class_indices.json"))
    log.info("train images: %d  classes: %s", len(train_ds), train_ds.classes)
    # the model and seq ranks of one data rank read the same shard
    train_loader = BatchLoader(train_ds, local_bs, cfg.image_size,
                               train=True, seed=cfg.seed,
                               num_threads=cfg.num_workers,
                               shard_index=mesh.data_index,
                               shard_count=mesh.dp)

    build = lambda **kw: create_model(
        cfg.model, num_classes=cfg.num_classes,
        use_checkpoint=cfg.use_checkpoint, scan_impl=cfg.scan_impl,
        generator=torch.Generator().manual_seed(cfg.seed),
        **({"seq_axis": "seq"} if cfg.sp > 1 else {}), **kw)
    model = build()
    if mesh.tp > 1:
        # the full-width init from the seed, each rank keeping its pieces
        full = model.state_dict()
        model = build(model_axis="model")
        load_full_state_dict(model, full)
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
                 m["loss"], m["accuracy"], m["img_s"] * mesh.dp)
        every = cfg.kan_update_grid_every
        if every and (epoch + 1) % every == 0 and has_kan_grids(model):
            batches = train_loader.epoch(epoch)
            imgs0, _ = next(batches)
            batches.close()
            kan_grid_update(model, torch.from_numpy(imgs0).to(device))
            log.info("KAN grids updated at epoch %d", epoch)
        if val_ds is not None:
            val_loader = BatchLoader(val_ds, local_bs, cfg.image_size,
                                     train=False)
            n_correct, labels, _ = run_eval(model, val_loader, device)
            # every rank evaluates the whole set; rank 0's count decides,
            # so that every rank takes the same branch below
            acc = main_process_value(n_correct, device) / max(len(labels), 1)
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
    main(parse_args())
