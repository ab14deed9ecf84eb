"""Grad-CAM CLI of the port: one image's heatmap over its stages, blended
onto the image and written as a PNG of the image's (resized) size.

  python -m medical_image_classification_tpu_torch.cli.cam \
      --image img.png --model medmamba --weights model.pt \
      --out cam.png [--stages layers_2,layers_3] [--target 3] [--device cuda]

``--weights`` is a ``torch.save``d port ``state_dict``, as in
``cli/test.py``; the model runs in fp32 (the JAX CLI's dtype).  Stage
names are the JAX package's (``layers_0`` ... ``layers_3``).
"""

from __future__ import annotations

import argparse
import logging

import torch

from medical_image_classification_tpu_torch.data.image_folder import (
    load_eval_image,
)
from medical_image_classification_tpu_torch.evaluate.gradcam import (
    grad_cam,
    overlay_heatmap,
)
from medical_image_classification_tpu_torch.models import create_model

log = logging.getLogger("mic_torch")


def main(args):
    """Writes ``args.out``; returns the heatmap [H, W] in [0, 1]."""
    import cv2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    model = create_model(args.model, num_classes=args.num_classes).to(device)
    if args.weights:
        sd = torch.load(args.weights, map_location=device, weights_only=True)
        model.load_state_dict(sd, strict=True)
    img = load_eval_image(args.image, args.image_size)[None]
    stages = args.stages.split(",") if args.stages else None
    target = None if args.target is None else [args.target]
    cam = grad_cam(model, img, targets=target, stages=stages)[0]
    out = overlay_heatmap(img[0], cam, alpha=args.alpha)
    cv2.imwrite(args.out, out[:, :, ::-1])
    log.info("wrote %s", args.out)
    return cam


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--model", default="medmamba")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--weights", default=None)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--stages", default=None,
                   help="comma-separated stage names (default: all)")
    p.add_argument("--target", type=int, default=None)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--out", default="cam.png")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
