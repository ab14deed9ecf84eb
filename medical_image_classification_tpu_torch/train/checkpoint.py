"""Checkpoints: the composite resume format and the best-model weights.

Port of ``medical_image_classification_tpu/train/checkpoint.py`` with
``torch.save`` in place of orbax.  ``save_checkpoint`` writes
``<dir>/epoch_<n>.pt`` holding {model, optimizer, scheduler, step, epoch,
best_acc, drop_path_rng} and keeps the newest ``max_to_keep``;
``save_params_only`` writes the model's ``state_dict`` alone (what
``cli/test.py --weights`` loads), ``load_params_only`` reads it back into a
model (``cli/fusion_test.py --weights``).  In a job of several ranks every
rank holds the same state: rank 0 alone writes, and every rank waits on a
barrier after each save, so a restore on any rank reads a whole file.
Under tensor parallelism (a current mesh with tp > 1) a rank holds its
piece of each split leaf: every save first joins the full ``state_dict``
and the full optimizer moments over the model axis (a collective of every
rank), and every load cuts the file's full tensors to the rank's pieces
(``parallel/sharding.py``), so the files are the unsharded model's and a
run resumes at any tp.
"""

from __future__ import annotations

import os
import re

import torch

from medical_image_classification_tpu_torch.parallel.mesh import (
    barrier,
    current_mesh,
    is_main_process,
)
from medical_image_classification_tpu_torch.parallel.sharding import (
    gather_optimizer_state,
    gather_state_dict,
    shard_optimizer_state,
    shard_state_dict,
)

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _epochs(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def _tp_mesh():
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.tp > 1 else None


def full_state_dict(model):
    """The model's full ``state_dict``: under tensor parallelism joined over
    the model axis (every rank calls)."""
    mesh = _tp_mesh()
    sd = model.state_dict()
    return sd if mesh is None else gather_state_dict(sd, mesh)


def load_full_state_dict(model, sd):
    """Load a full ``state_dict`` into ``model`` (strict), each split leaf
    cut to the rank's piece under tensor parallelism."""
    mesh = _tp_mesh()
    model.load_state_dict(sd if mesh is None else shard_state_dict(sd, mesh),
                          strict=True)


def save_checkpoint(ckpt_dir: str, model, optimizer, scheduler, state,
                    epoch: int, max_to_keep: int = 3):
    """Write epoch ``epoch``'s composite checkpoint, then drop all but the
    newest ``max_to_keep`` (rank 0; every rank waits for it)."""
    mesh = _tp_mesh()
    osd = optimizer.state_dict()
    payload = {
        "model": full_state_dict(model),
        "optimizer": osd if mesh is None else gather_optimizer_state(
            osd, optimizer, model, mesh),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "best_acc": state.best_acc,
        "drop_path_rng": model.drop_path_rng.get_state(),
    }
    if is_main_process():
        _write(ckpt_dir, payload, epoch, max_to_keep)
    barrier()


def _write(ckpt_dir, payload, epoch, max_to_keep):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = _path(ckpt_dir, epoch) + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _path(ckpt_dir, epoch))     # never a half-written file
    for old in _epochs(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def restore_checkpoint(ckpt_dir: str, model, optimizer, scheduler, state,
                       epoch: int | None = None):
    """Load epoch ``epoch`` (default: the newest) into the model, optimizer,
    scheduler and ``state``.  Returns (epoch, best_acc), or (-1, 0.0) when
    there is nothing to restore."""
    epochs = _epochs(ckpt_dir)
    if epoch is None:
        if not epochs:
            return -1, 0.0
        epoch = epochs[-1]
    device = next(model.parameters()).device
    payload = torch.load(_path(ckpt_dir, epoch), map_location=device,
                         weights_only=True)
    load_full_state_dict(model, payload["model"])
    mesh = _tp_mesh()
    optimizer.load_state_dict(
        payload["optimizer"] if mesh is None else shard_optimizer_state(
            payload["optimizer"], optimizer, model, mesh))
    if scheduler is not None and payload["scheduler"] is not None:
        scheduler.load_state_dict(payload["scheduler"])
    model.drop_path_rng.set_state(payload["drop_path_rng"])
    state.step, state.best_acc = payload["step"], payload["best_acc"]
    return int(payload["epoch"]), float(payload["best_acc"])


def save_params_only(path: str, model):
    """The best-model save: the model's ``state_dict`` (parameters and
    BatchNorm running stats, no optimizer state; the full one under tensor
    parallelism); rank 0 writes, every rank waits for it."""
    sd = full_state_dict(model)
    if is_main_process():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(sd, path)
    barrier()


def load_params_only(path: str, model):
    """Load what ``save_params_only`` wrote into ``model`` (strict), on the
    device of the model's parameters.  The file also holds the BatchNorm
    running stats, which the JAX package's weights-only save leaves out."""
    device = next(model.parameters()).device
    load_full_state_dict(model, torch.load(path, map_location=device,
                                           weights_only=True))
    return model
