"""The training config and its command line.

A copy of ``medical_image_classification_tpu/utils/config.py``
(``TrainConfig``, ``add_args``, ``from_args``), kept here so that the
port's training path imports nothing of the JAX package, plus the port's
own ``device`` and ``dist_backend`` (the process group's backend: "nccl",
one rank a GPU, or "gloo").
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
    # parallelism: tensor parallelism (each SS2D layer's d_inner channels,
    # or heads, split over tp ranks), sequence parallelism (the SS2D scans
    # L-sharded over sp ranks)
    tp: int = 1
    sp: int = 1
    # io
    save_path: str = "runs/model.ckpt"
    resume: Optional[str] = None
    log_every: int = 50
    # kan: re-grid the KAN head every N epochs (0: never)
    kan_update_grid_every: int = 0
    # the port's own
    device: str = "cuda"
    dist_backend: str = "nccl"


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
