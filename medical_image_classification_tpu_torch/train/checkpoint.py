"""Checkpoints: the composite resume format and the best-model weights.

Port of ``medical_image_classification_tpu/train/checkpoint.py`` with
``torch.save`` in place of orbax.  ``save_checkpoint`` writes
``<dir>/epoch_<n>.pt`` holding {model, optimizer, scheduler, step, epoch,
best_acc, drop_path_rng} and keeps the newest ``max_to_keep``;
``save_params_only`` writes the model's ``state_dict`` alone (what
``cli/test.py --weights`` loads).
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _epochs(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def save_checkpoint(ckpt_dir: str, model, optimizer, scheduler, state,
                    epoch: int, max_to_keep: int = 3):
    """Write epoch ``epoch``'s composite checkpoint, then drop all but the
    newest ``max_to_keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "best_acc": state.best_acc,
        "drop_path_rng": model.drop_path_rng.get_state(),
    }
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
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None and payload["scheduler"] is not None:
        scheduler.load_state_dict(payload["scheduler"])
    model.drop_path_rng.set_state(payload["drop_path_rng"])
    state.step, state.best_acc = payload["step"], payload["best_acc"]
    return int(payload["epoch"]), float(payload["best_acc"])


def save_params_only(path: str, model):
    """The best-model save: the model's ``state_dict`` (parameters and
    BatchNorm running stats, no optimizer state)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)
