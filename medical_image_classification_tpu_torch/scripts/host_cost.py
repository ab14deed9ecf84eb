"""The host's share of an eval forward on the card, and of one kernel call.

  python -m medical_image_classification_tpu_torch.scripts.host_cost \
      [--reps 30] [--tag NAME]

On a machine with a CUDA device (it raises without one), from the root of
a checkout: builds the forward kernels the eval paths launch (one nvcc
each, all at once), then prints one JSON line: for medmamba, st_ssd and
medssd (224x224, batch 32, bf16, seeded weights) the wall ms of
``--reps`` eval forwards on a batch already on the card (median and
quartiles), and the host microseconds of one small selective-scan call
(G 8, L 64, Dm 64, N 16) through ``scan_folded_fwd`` and through its
launcher alone.  To compare two trees, run it from each tree's root in
turns (parent, change, change, parent) in one session on one card.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import torch

KERNELS = ("selective_scan_fwd", "ssd_fused_dirs_fwd", "ssd_ydiag_fwd",
           "stl_mixer_fwd", "stf_zgate_fwd")
MODELS = ("medmamba", "st_ssd", "medssd")


def _quartiles(ms):
    ms = sorted(ms)
    n = len(ms)
    return dict(median=ms[n // 2], q1=ms[n // 4], q3=ms[3 * n // 4])


def forward_ms(name: str, reps: int) -> dict:
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_eval_step)
    model = create_model(name, 8, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model.cuda())
    x = torch.randint(0, 256, (32, 224, 224, 3), dtype=torch.uint8,
                      device="cuda")
    y = torch.zeros(32, dtype=torch.long, device="cuda")
    for _ in range(3):
        step(x, y)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return _quartiles(ms)


def scan_call_us(calls: int = 2000) -> dict:
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as f)
    G, L, Dm, N = 8, 64, 64, 16
    r = lambda *s: torch.randn(*s, device="cuda")
    args = (r(G, L, Dm), r(G, L, Dm), -torch.rand(1, Dm, N, device="cuda"),
            r(G, L, N), r(G, L, N), r(1, Dm), r(1, Dm))
    out = {}
    with torch.no_grad():
        for what, fn in (("wrapper", lambda: f.scan_folded_fwd(*args)),
                         ("launcher", lambda: f._launch_cuda(*args, False,
                                                             True))):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[what] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--tag", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("host_cost needs a CUDA device")
    from medical_image_classification_tpu_torch.kernels import _build
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {name: forward_ms(name, args.reps) for name in MODELS}
    res["scan_call_us"] = scan_call_us()
    print(json.dumps(dict(tag=args.tag, **res)), flush=True)
    return res


if __name__ == "__main__":
    main()
