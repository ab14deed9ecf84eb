"""Ahead-of-time export of a classifier for serving, through
``torch.export``.

Serializes uint8 NHWC images -> ``normalize_batch`` -> the model in eval
mode -> logits, with the weights inside, into a ``.pt2`` program
(``torch.export.save``) that reloads with ``torch.export.load`` and runs
without the model code, the registry or a checkpoint.  The hand-written
kernels are in the program as ``mic_torch::*`` custom ops
(``kernels/ops.py``): they launch the CUDA kernels on the card and run the
plain versions on the CPU, and a program that holds them loads only where
``kernels/ops.py`` has been imported (``load_and_check`` imports it, and
nothing of the models).  The program runs on the device it was exported
on, so the JAX CLI's ``--platform`` has no counterpart here.

  python -m medical_image_classification_tpu_torch.cli.export \
      --model medmamba --weights model.pt --batch-size 8 \
      --out runs/medmamba.pt2 [--dtype bf16|fp32] [--device cuda]

  # check a saved program (a seeded uint8 batch; prints the logits' shape):
  python -m medical_image_classification_tpu_torch.cli.export \
      --load runs/medmamba.pt2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn as nn


class ServeModule(nn.Module):
    """uint8 [B, H, W, 3] -> logits [B, classes] (fp32)."""

    def __init__(self, model):
        super().__init__()
        from medical_image_classification_tpu_torch.data.image_folder import (
            normalize_batch)
        self.model = model
        self.normalize = normalize_batch

    def forward(self, images_u8):
        return self.model(self.normalize(images_u8))


def build_serve_module(model_name: str, num_classes: int,
                       weights: str | None, batch_size: int,
                       image_size: int, dtype, device):
    """Returns (module, example_args): the model (``weights`` a
    ``torch.save``d port ``state_dict``) in eval mode on ``device`` with
    its parameters frozen, behind ``normalize_batch``."""
    from medical_image_classification_tpu_torch.models import create_model

    model = create_model(model_name, num_classes=num_classes, dtype=dtype)
    if weights:
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    imgs = torch.zeros((batch_size, image_size, image_size, 3),
                       dtype=torch.uint8, device=device)
    return ServeModule(model).eval(), (imgs,)


def export_model(args):
    """Export and save; returns (program, {"trace_s", "save_s", "bytes"})."""
    device = _device(args.device)
    dtype = {"bf16": torch.bfloat16, "fp32": None}[args.dtype]
    serve, ex_args = build_serve_module(args.model, args.num_classes,
                                        args.weights, args.batch_size,
                                        args.image_size, dtype, device)
    with torch.no_grad():
        # one eager forward first: the model's cached constants (the ST-SSD
        # pooling matrices) are then real tensors, which the trace takes in
        # as constants of the program
        serve(*ex_args)
        t0 = time.perf_counter()
        program = torch.export.export(serve, ex_args, strict=False)
        trace_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    torch.export.save(program, args.out)
    stats = dict(trace_s=trace_s, save_s=time.perf_counter() - t0,
                 bytes=os.path.getsize(args.out))
    (x,) = ex_args
    print(f"exported {args.model} -> {args.out} ({stats['bytes']} bytes, "
          f"trace {trace_s:.2f} s, save {stats['save_s']:.2f} s; in "
          f"{tuple(x.shape)} {x.dtype} on {x.device}, ops "
          f"{sorted(op_calls(program))})", flush=True)
    return program, stats


def op_calls(program) -> dict:
    """{``mic_torch`` op name: calls in the program's graph}."""
    from medical_image_classification_tpu_torch.kernels.ops import NAMESPACE
    calls = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith(NAMESPACE + "::"):
            calls[name] = calls.get(name, 0) + 1
    return calls


def load_and_check(path: str):
    """Load ``path`` and run it once on a seeded uint8 batch of its input
    shape, on the device it was exported on; prints and returns the
    logits."""
    # registers the mic_torch ops the program calls
    from medical_image_classification_tpu_torch.kernels import ops  # noqa: F401
    program = torch.export.load(path)
    user = set(program.graph_signature.user_inputs)
    spec = next(n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name in user)
    _device(spec.device.type)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, tuple(spec.shape), dtype=np.uint8)).to(spec.device)
    with torch.no_grad():
        out = program.module()(x)
    print(f"loaded {path}: {tuple(spec.shape)} {spec.dtype} -> "
          f"{tuple(out.shape)} {out.dtype}; "
          f"logits[0,:4]={out[0, :4].float().cpu().numpy()}", flush=True)
    return out


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the program runs on {name}, but torch sees no "
                           "CUDA device")
    return device


def main(args):
    if args.load:
        return load_and_check(args.load)
    return export_model(args)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="medmamba")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--weights", default=None,
                   help="a torch.save'd port state_dict")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--out", default="runs/model.pt2")
    p.add_argument("--load", default=None,
                   help="check a saved program instead of exporting")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
