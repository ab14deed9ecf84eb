"""Evaluation CLI of the port: top-1 accuracy on an ImageFolder, or with
``--all-index`` the full metric suite (accuracy, macro precision, recall,
specificity and F1, macro one-vs-rest AUC, the parameter count) and its
one-row CSV.

  python -m medical_image_classification_tpu_torch.cli.test \
      --data-path /data/oct/test --model medmamba --weights model.pt \
      [--all-index --csv-out metrics.csv] [--device cuda]

``--weights`` is a ``torch.save``d port ``state_dict`` (for weights trained
with the JAX package, see ``utils/weights.py``).  The AUC's scores are the
softmax of the fp32 logits.
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
from medical_image_classification_tpu_torch.evaluate.metrics import (
    classification_metrics,
    count_parameters,
    metrics_to_csv,
)
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


def all_index(model, y, logits, num_classes: int, name: str,
              csv_out: str | None = None) -> dict:
    """The metric suite of labels ``y`` [n] and fp32 ``logits`` [n,
    classes], with ``param_count``; written to ``csv_out`` as one row with
    ``model`` = ``name`` when given."""
    scores = torch.softmax(torch.from_numpy(logits).float(), dim=-1).numpy()
    m = classification_metrics(y, logits.argmax(-1), scores,
                               num_classes=num_classes)
    m["param_count"] = count_parameters(model)
    for k, v in m.items():
        log.info("%s: %s", k, v)
    if csv_out:
        metrics_to_csv(csv_out, m, extra={"model": name})
        log.info("wrote %s", csv_out)
    return m


def main(args):
    """Top-1 accuracy, or with ``args.all_index`` the metrics' dict."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    ds = scan_image_folder(args.data_path)
    model = create_model(args.model, num_classes=args.num_classes).to(device)
    if args.weights:
        sd = torch.load(args.weights, map_location=device, weights_only=True)
        model.load_state_dict(sd, strict=True)
    loader = BatchLoader(ds, args.batch_size, args.image_size, train=False)
    n_correct, y, logits = run_eval(model, loader, device)
    if args.all_index:
        return all_index(model, y, logits, args.num_classes, args.model,
                         args.csv_out)
    acc = n_correct / len(y)
    log.info("test top-1 accuracy: %.4f (%d images)", acc, len(y))
    return acc


def parser(doc: str = __doc__) -> argparse.ArgumentParser:
    """The options this CLI and ``cli/test_all_index.py`` share."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--data-path", required=True)
    p.add_argument("--model", default="medmamba")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    return p


def parse_args(argv=None):
    p = parser()
    p.add_argument("--all-index", action="store_true")
    p.add_argument("--csv-out", default=None)
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
