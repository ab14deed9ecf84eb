"""Rank-0-gated logging (console and file).

Port of ``medical_image_classification_tpu/utils/logging_utils.py``: a
stdlib logger whose handlers exist on the job's first rank only
(``torch.distributed.get_rank() == 0`` when a process group is up, every
process otherwise); the other ranks' loggers drop what they are given.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import torch.distributed as dist


def get_logger(name: str = "mic_torch", log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """The logger ``name`` with a stdout handler and, given ``log_file``, a
    file handler on rank 0; a logger that already has handlers is returned
    as it is."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    is_main = not dist.is_initialized() or dist.get_rank() == 0
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if is_main:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    return logger
