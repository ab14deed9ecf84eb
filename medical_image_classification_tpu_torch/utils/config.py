"""The training config and its command line.

A copy of ``medical_image_classification_tpu/utils/config.py``
(``TrainConfig``, ``add_args``, ``from_args``), kept here so that the
port's training path imports nothing of the JAX package, plus ``device``.
``tp``, ``sp`` and ``kan_update_grid_every`` are accepted, and any value
but the default raises (``check_ported``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    # data
    data_path: str = "data/train"
    val_path: Optional[str] = None          # default: sibling 'val' of train
    image_size: int = 224
    num_workers: int = 8
    # model
    model: str = "medmamba"
    num_classes: int = 8
    use_checkpoint: bool = False            # activation checkpointing
    scan_impl: str = "auto"                 # auto | cuda | torch
    # optimization (reference defaults)
    batch_size: int = 32
    epochs: int = 100
    lr: float = 1e-4
    optimizer: str = "adam"
    schedule: str = "constant"
    weight_decay: float = 0.0
    warmup_epochs: int = 0
    label_smoothing: float = 0.0
    grad_clip: Optional[float] = None
    seed: int = 0
    # parallelism (not ported yet)
    tp: int = 1
    sp: int = 1
    # io
    save_path: str = "runs/model.ckpt"
    resume: Optional[str] = None
    log_every: int = 50
    # kan (not ported yet)
    kan_update_grid_every: int = 0
    # the port's own
    device: str = "cuda"


def check_ported(cfg: TrainConfig) -> None:
    """Raise for the options whose code paths are not ported yet."""
    for name in ("tp", "sp", "kan_update_grid_every"):
        default = getattr(TrainConfig, name)
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {getattr(cfg, name)}: not "
                f"ported yet (only the default {default} runs)")


def add_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(cfg):
        name = "--" + f.name.replace("_", "-")
        default = getattr(cfg, f.name)
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=default)
        elif default is None:
            parser.add_argument(name, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def from_args(cls, args: argparse.Namespace):
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
          if hasattr(args, f.name)}
    # argparse gives strings for Optional fields
    for k in ("grad_clip",):
        if k in kw and isinstance(kw[k], str):
            kw[k] = float(kw[k])
    return cls(**kw)
