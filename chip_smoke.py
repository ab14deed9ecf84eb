#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), the
     selective-scan kernel compiled from csrc/ into build/torch_kernels/;
  2. kernel vs plain: the CUDA selective-scan forward against its plain
     PyTorch version at MedMamba's four stage shapes (G 32, N 16), forward
     and reverse, fp32 and bf16, with times from CUDA events;
  3. full model: medmamba (224x224, batch 32, 8 classes, seeded random
     weights with the scan parameters drawn away from init, bf16 compute,
     fp32 params) through cli.test.run_eval; counts
     the scan kernel's launches, checks the logits against the same model
     with the plain scan (bf16, and fp32 on one batch), times eval, and
     profiles one eval forward (device time by kernel).
Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
before printing any result.  ``--out`` writes the per-case numbers and
the profile as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STAGES = ((3136, 96), (784, 192), (196, 384), (49, 768))  # (L, Dm) at 224²
G, N = 32, 16
BATCH, SIZE, CLASSES, STEPS = 32, 224, 8, 4
SCAN_CALLS_PER_FORWARD = 4 * (2 + 2 + 4 + 2)       # 4 directions x blocks
# kernel vs plain, per element: |k - p| <= atol + rtol * |p|
TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 5e-2)}
# full-model logits, kernel scan vs plain scan (same weights and inputs):
# fp32 differs only in summation order and exp; bf16 also where a scan
# output rounds to the other neighbouring bf16 value, carried through 10
# blocks
LOGIT_TOL = {"fp32": 2e-3, "bf16": 5e-2}


def _events_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device_and_build():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    from medical_image_classification_tpu_torch.kernels import _build
    res = _build.build("selective_scan_fwd")
    _build.library("selective_scan_fwd")
    ptxas = [" ".join(ln.split()) for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 device+build: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | selective_scan_fwd built in "
          f"{res.seconds:.2f} s -> {res.path.name} | ptxas: "
          f"{' / '.join(ptxas) or 'cached build'}", flush=True)
    return card


def phase_kernel_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (  # noqa: E501
        scan_folded_fwd, scan_folded_fwd_ref)
    dev = torch.device("cuda")
    cases = []
    for i, (L, Dm) in enumerate(STAGES):
        gen = torch.Generator(device=dev).manual_seed(i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        base = dict(u=rnd(G, L, Dm), delta=0.5 * rnd(G, L, Dm),
                    B=rnd(G, L, N), C=rnd(G, L, N))
        # MedMamba's S4D-real init: A = -(1..N) for every channel
        A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
            1, Dm, N).contiguous()
        D = rnd(1, Dm)
        bias = 0.1 * rnd(1, Dm)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            act = {k: v.to(dtype) for k, v in base.items()}
            for reverse in (False, True):
                args = (act["u"], act["delta"], A, act["B"], act["C"], D,
                        bias)
                run_k = lambda: scan_folded_fwd(*args, reverse=reverse,
                                                impl="cuda")
                run_p = lambda: scan_folded_fwd_ref(*args, reverse=reverse)
                yk, yp = run_k(), run_p()
                torch.cuda.synchronize()
                rtol, atol = TOL[dt_name]
                diff = (yk.float() - yp.float()).abs()
                err = float(diff.max())
                bound = atol + rtol * yp.float().abs()
                if not bool(torch.isfinite(yk).all()) or \
                        bool((diff > bound).any()):
                    raise AssertionError(
                        f"kernel vs plain L={L} Dm={Dm} {dt_name} "
                        f"reverse={reverse}: max err {err:.3e} outside "
                        f"rtol={rtol} atol={atol}")
                k_ms = _events_ms(run_k, 20)
                p_ms = _events_ms(run_p, 2)
                cases.append(dict(L=L, Dm=Dm, dtype=dt_name, reverse=reverse,
                                  max_abs_err=err, ms=k_ms, plain_ms=p_ms))
    worst = {d: max(c["max_abs_err"] for c in cases if c["dtype"] == d)
             for d in TOL}
    summary = "; ".join(
        f"{c['L']}x{c['Dm']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'}"
        f" err={c['max_abs_err']:.2e} kernel={c['ms']:.4f}ms "
        f"plain={c['plain_ms']:.2f}ms" for c in cases)
    print(f"phase 2 kernel vs plain: {len(cases)}/16 cases within tolerance "
          f"(worst fp32 {worst['fp32']:.2e}, bf16 {worst['bf16']:.2e}; "
          f"G={G} N={N}) | {summary}", flush=True)
    return cases


def _model(dtype, scan_impl, state_dict=None):
    """Seeded medmamba on the card.  Without ``state_dict``, the scan
    parameters are then drawn away from their init: at init D = 1 and
    Δ is small, so y ≈ u and a bf16 scan output rounds back to u whatever
    the state term; D ~ U(-1, 1), Δ ~ U(0.05, 0.5) and a 4x x_proj make
    the state term show in the logits."""
    import torch
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.models.ss2d_modules import (
        SS2D)
    gen = torch.Generator().manual_seed(0)
    model = create_model("medmamba", CLASSES, dtype=dtype,
                         scan_impl=scan_impl, generator=gen)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, SS2D):
                    m.Ds.uniform_(-1.0, 1.0, generator=gen)
                    dt = torch.empty(m.dt_projs_bias.shape).uniform_(
                        0.05, 0.5, generator=gen)
                    m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                    m.x_proj_weight.mul_(4.0)
    return model.cuda().eval()


def _check_logits(name, got, want, tol):
    import numpy as np
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits")
    scale = float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    if err > tol * scale:
        raise AssertionError(f"{name}: kernel vs plain-scan logits max err "
                             f"{err:.3e} > {tol} x {scale:.3f}")
    return err


def phase_full_model(card):
    import torch
    from medical_image_classification_tpu_torch.cli.test import run_eval
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (  # noqa: E501
        scan_folded_fwd)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    model = _model(bf16, "auto")
    run_eval(model, SyntheticLoader(BATCH, SIZE, CLASSES, steps=1, seed=1),
             dev)                                      # warm-up
    loader = SyntheticLoader(BATCH, SIZE, CLASSES, steps=STEPS, seed=0)
    torch.cuda.synchronize()
    scan_folded_fwd.launches = 0
    t0 = time.perf_counter()
    n_correct, labels, logits = run_eval(model, loader, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = scan_folded_fwd.launches
    if launches != SCAN_CALLS_PER_FORWARD * STEPS:
        raise AssertionError(f"scan kernel launched {launches} times in "
                             f"{STEPS} forwards, expected "
                             f"{SCAN_CALLS_PER_FORWARD} per forward")
    if logits.shape != (BATCH * STEPS, CLASSES):
        raise AssertionError(f"logits shape {logits.shape}")
    img_s = BATCH * STEPS / seconds

    # the same weights with the plain scan, on the first batch
    sd = model.state_dict()
    one = SyntheticLoader(BATCH, SIZE, CLASSES, steps=1, seed=0)
    _, _, ref16 = run_eval(_model(bf16, "torch", sd), one, dev)
    err16 = _check_logits("bf16", logits[:BATCH], ref16, LOGIT_TOL["bf16"])
    _, _, k32 = run_eval(_model(None, "cuda", sd), one, dev)
    _, _, ref32 = run_eval(_model(None, "torch", sd), one, dev)
    err32 = _check_logits("fp32", k32, ref32, LOGIT_TOL["fp32"])
    if scan_folded_fwd.launches != launches + SCAN_CALLS_PER_FORWARD:
        raise AssertionError("the plain-scan models launched the kernel, or "
                             "the fp32 kernel model did not")

    prof_rows = _profile_forward(model, dev)
    kernel_us = [r for r in prof_rows if r["cpu_us"] == 0.0]
    total_us = sum(r["device_us"] for r in kernel_us)
    top = ", ".join(f"{r['name'][:48]} {r['device_us'] / 1e3:.2f} ms"
                    for r in kernel_us[:4])
    print(f"phase 3 medmamba {SIZE}x{SIZE} b{BATCH} bf16 via run_eval: "
          f"{STEPS} batches, {launches} scan-kernel launches "
          f"({launches // STEPS} per forward), logits {logits.shape} finite "
          f"| kernel vs plain-scan logits max err bf16 {err16:.3e} "
          f"(tol {LOGIT_TOL['bf16']} x max|logit|), fp32 {err32:.3e} "
          f"(tol {LOGIT_TOL['fp32']} x max|logit|) | eval {img_s:.2f} img/s "
          f"({seconds:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | one forward: {total_us / 1e3:.2f} ms "
          f"device time in kernels; top: {top}", flush=True)
    return dict(launches=launches, img_s=img_s, seconds=seconds,
                logit_err_bf16=err16, logit_err_fp32=err32,
                top1=n_correct / len(labels), profile=prof_rows)


def _profile_forward(model, dev):
    """Time by op and kernel over one eval forward (torch.profiler); rows
    with no CPU time are device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                      device=dev)
    from medical_image_classification_tpu_torch.train.eval_step import (
        make_eval_step)
    step = make_eval_step(model)
    labels = torch.zeros(BATCH, dtype=torch.long, device=dev)
    step(x, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, labels)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        rows.append(dict(name=ev.key, count=ev.count,
                         device_us=float(dev_us),
                         cpu_us=float(ev.cpu_time_total)))
    rows.sort(key=lambda r: -r["device_us"])
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default=None,
                   help="write the per-case numbers here as JSON")
    args = p.parse_args(argv)

    card = phase_device_and_build()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = phase_kernel_vs_plain()
    full = phase_full_model(card)

    leaked = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "flax", "optax"))
                    or m.split(".")[0] == "medical_image_classification_tpu")
    if leaked:
        raise AssertionError(f"the port's path imported {leaked[:5]}")
    head = next(c for c in cases
                if c["L"] == STAGES[0][0] and c["dtype"] == "bf16"
                and not c["reverse"])
    kernels = {"kernels": [{
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "medical_image_classification_tpu_torch/csrc/"
                  "selective_scan_fwd.cu",
        "replaces": "medical_image_classification_tpu/kernels/"
                    "selective_scan_pallas_v2.py:36",
        "launches": full["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"]}]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, full_model=full), f,
                      indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
