"""Distributed training entry point of the port.  Port of
``medical_image_classification_tpu/cli/ddp_train.py``: the train CLI
(``cli/train.py``, whose docstring says how the ranks share the work) plus
``--auto-resume``, which continues from the newest checkpoint under
``--save-path`` when one is there.  Launched by torchrun, one process a
rank:

  torchrun --nproc-per-node N -m \\
      medical_image_classification_tpu_torch.cli.ddp_train \\
      --data-path /data/oct/train --epochs 100 --batch-size 32 \\
      [--tp 2] [--sp 2] [--dist-backend gloo] [--auto-resume]

The backend is NCCL by default (one rank a GPU on ``cuda:LOCAL_RANK``);
``--dist-backend gloo`` lets ranks share a card or run on the CPU
(``--device cpu``).  The default device is the card: without one, main()
raises before it reads the data.
"""

from __future__ import annotations

import argparse
import os

from medical_image_classification_tpu_torch.cli.train import main
from medical_image_classification_tpu_torch.utils.config import (
    TrainConfig,
    add_args,
    from_args,
)


def parse_args(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(description=__doc__)
    add_args(p, TrainConfig())
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the save-path checkpoint if it exists")
    args = p.parse_args(argv)
    cfg = from_args(TrainConfig, args)
    if args.auto_resume and not cfg.resume and os.path.isdir(cfg.save_path):
        cfg.resume = cfg.save_path
    return cfg


if __name__ == "__main__":
    main(parse_args())
