"""CT/MRI fusion inference CLI of the port.  Port of
``medical_image_classification_tpu/cli/fusion_test.py``.

  python -m medical_image_classification_tpu_torch.cli.fusion_test \
      --data-path /data/CT_MRI --weights runs/fusion.pt --out-dir fused/ \
      [--single-decoder] [--device cuda]

For each pair (one at a time, 256x256 grayscale repeated to 3 channels)
the fused image is clamped to [0, 1], min-max scaled and written as
``<out-dir>/<name>_fused.png``; the wall time of the loop is logged.
``--weights`` is a ``state_dict`` from ``cli/fusion_train.py``; the model
options must be the ones it was trained with.  It runs on the card unless
``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from medical_image_classification_tpu_torch.cli.fusion_train import (
    add_model_args,
    device_of,
    model_kwargs,
)
from medical_image_classification_tpu_torch.data.fusion_dataset import (
    load_fusion_image,
    scan_fusion_pairs,
)
from medical_image_classification_tpu_torch.models import create_fusion_model
from medical_image_classification_tpu_torch.train.checkpoint import (
    load_params_only,
)
from medical_image_classification_tpu_torch.train.eval_step import (
    make_fusion_eval_step,
)

log = logging.getLogger("mic_torch")


def main(args):
    """Fuse every pair; returns {paths: the PNGs written, seconds: the
    host clock over the pairs' loop (reads, forwards, writes)}."""
    import cv2
    device = device_of(args)
    pairs = scan_fusion_pairs(args.data_path, args.dir_a, args.dir_b)
    name = "vfefm_2c1" if args.single_decoder else "vfefm_2b2"
    model = create_fusion_model(name, **model_kwargs(args)).to(device)
    if args.weights:
        load_params_only(args.weights, model)
    infer = make_fusion_eval_step(model)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    t0 = time.perf_counter()
    for pa, pb in zip(pairs.a_paths, pairs.b_paths):
        xa, xb = (torch.from_numpy(load_fusion_image(
            p, args.image_size, 3)[None]).to(device) for p in (pa, pb))
        fused = infer(xa, xb)[0, ..., 0].cpu().numpy()
        mn, mx = fused.min(), fused.max()
        fused = (fused - mn) / max(mx - mn, 1e-8)
        out = os.path.join(args.out_dir, os.path.splitext(
            os.path.basename(pa))[0] + "_fused.png")
        cv2.imwrite(out, (fused * 255).astype(np.uint8))
        written.append(out)
    seconds = time.perf_counter() - t0
    log.info("fused %d pairs in %.2fs", len(pairs), seconds)
    return dict(paths=written, seconds=seconds)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--dir-a", default="CT")
    p.add_argument("--dir-b", default="MRI")
    p.add_argument("--weights", default=None)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--out-dir", default="fused")
    add_model_args(p)
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
