"""Evaluation CLI of the port: top-1 accuracy on an ImageFolder.

  python -m medical_image_classification_tpu_torch.cli.test \
      --data-path /data/oct/test --model medmamba --weights model.pt \
      [--device cuda]

``--weights`` is a ``torch.save``d port ``state_dict`` (for weights trained
with the JAX package, see ``utils/weights.py``).  The metric suite of the
JAX CLI's ``--all-index`` is not ported yet.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from medical_image_classification_tpu_torch.data.image_folder import (
    scan_image_folder,
)
from medical_image_classification_tpu_torch.data.loader import BatchLoader
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.eval_step import (
    make_eval_step,
)

log = logging.getLogger("mic_torch")


def run_eval(model, loader, device, epoch: int = 0):
    """Evaluate ``model`` on every batch of ``loader.epoch(epoch)``.

    A short last batch is padded to the loader's batch size (one input
    shape for the whole run) and the padding is dropped from the results.
    Returns (n_correct, labels [n], logits [n, classes]) with numpy arrays.
    """
    eval_step = make_eval_step(model)
    bs = loader.batch_size
    n_correct = 0
    ys, outs = [], []
    for imgs, labels in loader.epoch(epoch):
        n = imgs.shape[0]
        if n < bs:
            imgs = np.pad(imgs, ((0, bs - n), (0, 0), (0, 0), (0, 0)))
        # padding rows get label -1, which no argmax equals
        lab = np.full((bs,), -1, np.int64)
        lab[:n] = labels
        correct, logits = eval_step(torch.from_numpy(imgs).to(device),
                                    torch.from_numpy(lab).to(device))
        n_correct += int(correct)
        ys.append(np.asarray(labels))
        outs.append(logits[:n].float().cpu().numpy())
    return n_correct, np.concatenate(ys), np.concatenate(outs)


def main(args) -> float:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    ds = scan_image_folder(args.data_path)
    model = create_model(args.model, num_classes=args.num_classes).to(device)
    if args.weights:
        sd = torch.load(args.weights, map_location=device, weights_only=True)
        model.load_state_dict(sd, strict=True)
    loader = BatchLoader(ds, args.batch_size, args.image_size, train=False)
    n_correct, y, _ = run_eval(model, loader, device)
    acc = n_correct / len(y)
    log.info("test top-1 accuracy: %.4f (%d images)", acc, len(y))
    return acc


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--model", default="medmamba")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
