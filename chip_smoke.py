#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), both
     selective-scan kernels compiled from csrc/ into build/torch_kernels/
     (one nvcc each, started together), with each kernel's registers,
     shared memory and spills as ptxas reports them;
  2. forward kernel vs plain: the CUDA selective-scan forward against its
     plain PyTorch version at MedMamba's four stage shapes (G 32, N 16),
     forward and reverse, fp32 and bf16: y, and the saved chunk states
     (xsave) the backward reads, with times from CUDA events;
  2b. backward kernel vs plain: the CUDA backward against the plain
     backward on the same inputs and xsave at the same 16 cases, all seven
     gradients; a second launch must give the same bits; times from CUDA
     events; then, at one shape, ScanFolded's gradients against
     torch.autograd through the plain forward;
  3. eval: medmamba (224x224, batch 32, 8 classes, seeded random weights
     with the scan parameters drawn away from init, bf16 compute, fp32
     params) through cli.test.run_eval; counts the forward kernel's
     launches, checks the logits against the same model with the plain
     scan (bf16, and fp32 on one batch), times eval, and profiles one eval
     forward (device time by kernel);
  4. training: the same model in train mode through cli.train.run_train
     with Adam (lr 1e-4), one warm-up step then 4 timed steps; counts 40
     forward and 40 backward scan launches per step, checks a finite loss
     and that every parameter (the scan's included) moved; on one batch of
     4, every parameter's gradient with the kernels against the same
     weights with the plain scan (fp32 and bf16, leaf-wise rel-norm and
     cosine); train img/s and a profile of one step.
Then one JSON line describing the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.  Without a CUDA device
it exits non-zero before printing any result.  ``--out`` writes the
per-case numbers and the profiles as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STAGES = ((3136, 96), (784, 192), (196, 384), (49, 768))  # (L, Dm) at 224²
G, N = 32, 16
BATCH, SIZE, CLASSES, STEPS = 32, 224, 8, 4
SCAN_CALLS_PER_FORWARD = 4 * (2 + 2 + 4 + 2)       # 4 directions x blocks
KERNELS = ("selective_scan_fwd", "selective_scan_bwd")
# forward kernel vs plain, per element: |k - p| <= atol + rtol * |p|
TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 5e-2)}
# backward kernel vs plain, all seven gradients (rtol, atol): the ladder of
# tests/test_pallas_scan.py::test_pallas_production_grads.  fp32 differs
# only in summation order; bf16 is looser because du, dΔ, dB and dC are
# rounded to bf16 on both sides, and where the two fp32 sums straddle a
# rounding midpoint they land one bf16 step (2^-8 relative) apart
GRAD_TOL = {"fp32": (3e-3, 3e-3), "bf16": (6e-2, 1e-1)}
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
# full-model logits, kernel scan vs plain scan (same weights and inputs):
# fp32 differs only in summation order and exp; bf16 also where a scan
# output rounds to the other neighbouring bf16 value, carried through 10
# blocks
LOGIT_TOL = {"fp32": 2e-3, "bf16": 5e-2}
# full-model parameter gradients in fp32, kernel scan vs plain scan,
# leaf-wise (rel-norm, cosine, abs floor) as
# tests/test_reference_grad_parity.py:70
PARAM_GRAD_TOL = (2e-2, 0.998, 2e-4)
# In bf16 the two paths round activations to bf16 at the same places but
# land one bf16 step apart where their fp32 sums straddle a midpoint; that
# noise compounds through 10 blocks and the backward (a first run measured
# leaf rel-norm 0.30 between the two bf16 paths at the patch embed).  So
# each bf16 path is held against the fp32 plain gradients, and the kernels'
# median per-leaf rel-norm distance may be at most this many times the
# plain scan's (plus 1e-3): a faulty bf16 kernel lands O(1) away.  The
# median, because leaves whose true gradient is ~0 (the conv biases that
# feed a BatchNorm) have relative distances of 1e2-1e4 on both paths
BF16_GRAD_RATIO = 1.5
GRAD_BATCH = 4


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:       # one nvcc each
        results = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    parts = []
    for name, res in results.items():
        _build.library(name)
        ptxas = [" ".join(ln.split()) for ln in res.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        parts.append(f"{name} built in {res.seconds:.2f} s -> "
                     f"{res.path.name}; ptxas: "
                     f"{' / '.join(ptxas) or 'cached build'}")
    print(f"phase 1 device+build: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | " + " | ".join(parts), flush=True)
    return card


def _scan_cases():
    """The 16 stage cases: (L, Dm, dtype name, reverse, args), args the
    folded scan's (u, delta, A, B, C, D, bias) on the card."""
    import torch
    dev = torch.device("cuda")
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
                yield L, Dm, dt_name, reverse, (
                    act["u"], act["delta"], A, act["B"], act["C"], D, bias)


def _check_close(what, got, want, rtol, atol):
    """|got - want| <= atol + rtol |want| everywhere, and finite; returns
    the max abs error."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or \
            bool((diff > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{what}: max err {err:.3e} outside rtol={rtol} "
                             f"atol={atol}")
    return err


def phase_kernel_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd)
    cases = []
    for L, Dm, dt_name, reverse, args in _scan_cases():
        run_k = lambda: fwd.scan_folded_fwd(*args, reverse=reverse,
                                            impl="cuda")
        run_p = lambda: fwd.scan_folded_fwd_ref(*args, reverse=reverse)
        yk = run_k()
        yk2, xk = fwd._launch_cuda(*args, reverse, True, want_xsave=True)
        yp, xp = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                         want_xsave=True)
        torch.cuda.synchronize()
        what = f"forward kernel vs plain L={L} Dm={Dm} {dt_name} " \
               f"reverse={reverse}"
        if not torch.equal(yk, yk2):
            raise AssertionError(f"{what}: y changes when xsave is written")
        rtol, atol = TOL[dt_name]
        err = _check_close(what + " y", yk, yp, rtol, atol)
        xerr = _check_close(what + " xsave", xk, xp, rtol, atol)
        k_ms = _events_ms(run_k, 20)
        xs_ms = _events_ms(lambda: fwd._launch_cuda(
            *args, reverse, True, want_xsave=True), 20)
        p_ms = _events_ms(run_p, 2)
        cases.append(dict(L=L, Dm=Dm, dtype=dt_name, reverse=reverse,
                          max_abs_err=err, xsave_err=xerr, ms=k_ms,
                          xsave_ms=xs_ms, plain_ms=p_ms))
    worst = {d: max(c["max_abs_err"] for c in cases if c["dtype"] == d)
             for d in TOL}
    xworst = {d: max(c["xsave_err"] for c in cases if c["dtype"] == d)
              for d in TOL}
    summary = "; ".join(
        f"{c['L']}x{c['Dm']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'}"
        f" err={c['max_abs_err']:.2e} xsave_err={c['xsave_err']:.2e} "
        f"kernel={c['ms']:.4f}ms with_xsave={c['xsave_ms']:.4f}ms "
        f"plain={c['plain_ms']:.2f}ms" for c in cases)
    print(f"phase 2 forward kernel vs plain: {len(cases)}/16 cases within "
          f"tolerance, y and xsave (worst y fp32 {worst['fp32']:.2e}, bf16 "
          f"{worst['bf16']:.2e}; xsave fp32 {xworst['fp32']:.2e}, bf16 "
          f"{xworst['bf16']:.2e}; G={G} N={N}) | {summary}", flush=True)
    return cases


def phase_bwd_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as bwd, selective_scan_fwd as fwd)
    cases = []
    for L, Dm, dt_name, reverse, args in _scan_cases():
        _, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                           want_xsave=True)
        gen = torch.Generator(device="cuda").manual_seed(L + reverse)
        dy = torch.randn(args[0].shape, device="cuda",
                         generator=gen).to(args[0].dtype)
        run_k = lambda: bwd.scan_folded_bwd(*args, xsave, dy,
                                            reverse=reverse, impl="cuda")
        run_p = lambda: bwd.scan_folded_bwd_ref(*args, xsave, dy,
                                                reverse=reverse)
        gk, gk2, gp = run_k(), run_k(), run_p()
        torch.cuda.synchronize()
        what = f"backward kernel vs plain L={L} Dm={Dm} {dt_name} " \
               f"reverse={reverse}"
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        rtol, atol = GRAD_TOL[dt_name]
        errs = {nm: _check_close(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(GRAD_NAMES, gk, gp)}
        k_ms = _events_ms(run_k, 10)
        p_ms = _events_ms(run_p, 1)
        cases.append(dict(L=L, Dm=Dm, dtype=dt_name, reverse=reverse,
                          errs=errs, max_abs_err=max(errs.values()),
                          ms=k_ms, plain_ms=p_ms))

    # ScanFolded (kernels) against torch.autograd through the plain forward
    L, Dm, dt_name, reverse, args = next(
        c for c in _scan_cases() if c[0] == STAGES[2][0]
        and c[2] == "fp32" and c[3])
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dy = torch.randn(args[0].shape, device="cuda", generator=gen)
    fwd.scan_folded_fwd(*leaves, reverse=reverse, impl="cuda").backward(dy)
    got = [a.grad for a in leaves]
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(
        fwd.scan_folded_fwd_ref(*leaves, reverse=reverse), leaves, dy)
    rtol, atol = GRAD_TOL[dt_name]
    auto_err = max(_check_close(f"ScanFolded vs autograd {nm}", a, b, rtol,
                                atol)
                   for nm, a, b in zip(GRAD_NAMES, got, want))

    summary = "; ".join(
        f"{c['L']}x{c['Dm']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'}"
        f" err={c['max_abs_err']:.2e} kernel={c['ms']:.4f}ms "
        f"plain={c['plain_ms']:.1f}ms" for c in cases)
    print(f"phase 2b backward kernel vs plain: {len(cases)}/16 cases within "
          f"fp32 {GRAD_TOL['fp32']} bf16 {GRAD_TOL['bf16']} (rtol, atol) on "
          f"all 7 gradients, second launch bit-identical | ScanFolded vs "
          f"torch.autograd through the plain forward at {L}x{Dm} fp32 rev: "
          f"max err {auto_err:.2e} | {summary}", flush=True)
    return dict(cases=cases, autograd_err=auto_err)


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

    from medical_image_classification_tpu_torch.train.eval_step import (
        make_eval_step)
    step = make_eval_step(model)
    x = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                      device=dev)
    y = torch.zeros(BATCH, dtype=torch.long, device=dev)
    prof_rows = _profile(lambda: step(x, y))
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


def _profile(fn):
    """Time by op and kernel over one call of ``fn`` (torch.profiler), after
    one warm-up call; rows with no CPU time are device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
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


def _param_grads(model, imgs, labels, seed):
    """The train loss and every parameter's gradient on one batch (train
    mode: batch statistics, DropPath masks from ``seed``)."""
    from medical_image_classification_tpu_torch.data.image_folder import (
        normalize_batch)
    from medical_image_classification_tpu_torch.train.train_step import (
        cross_entropy_loss)
    model.train()
    model.seed_drop_path(seed)
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(normalize_batch(imgs)), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().flatten()
                         for n, p in model.named_parameters()}


def _check_grad_tree(what, got, want, rtol, min_cos, abs_floor):
    """Leaf-wise: a leaf passes if its error norm is under ``abs_floor`` or
    its rel-norm error is <= rtol with cosine >= min_cos.  Returns the
    worst (rel-norm error, cosine) over the leaves above the floor."""
    import torch
    worst_rel, worst_cos = 0.0, 1.0
    for name, w in want.items():
        g = got[name]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: non-finite gradient")
        diff = float((g - w).norm())
        if diff <= abs_floor:
            continue
        rel = diff / (float(w.norm()) + 1e-30)
        cos = float(g @ w) / (float(g.norm() * w.norm()) + 1e-30)
        if rel > rtol or cos < min_cos:
            raise AssertionError(f"{what} {name}: rel-norm err {rel:.3e} "
                                 f"(tol {rtol}), cosine {cos:.6f} (min "
                                 f"{min_cos}), |plain| {float(w.norm()):.3e}")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    return worst_rel, worst_cos


def phase_train(card):
    import math

    import torch
    from medical_image_classification_tpu_torch.cli.train import run_train
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.kernels.selective_scan_bwd import (  # noqa: E501
        scan_folded_bwd)
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (  # noqa: E501
        scan_folded_fwd)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_train_step)
    dev = torch.device("cuda")
    model = _model(torch.bfloat16, "auto")
    model.seed_drop_path(1)
    opt = make_optimizer("adam", model.named_parameters())
    sched = make_lr_scheduler(opt, make_schedule("constant", 1e-4))
    state = TrainState()
    run_train(model, opt, sched, SyntheticLoader(BATCH, SIZE, CLASSES,
                                                 steps=1, seed=1), dev,
              state=state)                              # warm-up
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = SyntheticLoader(BATCH, SIZE, CLASSES, steps=STEPS, seed=2)
    torch.cuda.synchronize()
    scan_folded_fwd.launches = scan_folded_bwd.launches = 0
    m = run_train(model, opt, sched, loader, dev, state=state)
    launches = (scan_folded_fwd.launches, scan_folded_bwd.launches)
    want = SCAN_CALLS_PER_FORWARD * STEPS
    if launches != (want, want):
        raise AssertionError(f"{STEPS} train steps launched the forward and "
                             f"backward scan kernels {launches} times, "
                             f"expected {SCAN_CALLS_PER_FORWARD} each per "
                             "step")
    if not math.isfinite(m["loss"]) or state.step != 1 + STEPS:
        raise AssertionError(f"train loss {m['loss']}, step {state.step}")
    still = sorted(n for n, p in model.named_parameters()
                   if torch.equal(p, before[n]))
    if still:
        raise AssertionError(f"{len(still)} parameters did not move in "
                             f"{STEPS} Adam steps: {still[:5]}")

    # every parameter's gradient: kernels against the plain scan, same
    # weights, same batch of GRAD_BATCH, same DropPath masks
    sd = model.state_dict()
    imgs, labels = next(SyntheticLoader(GRAD_BATCH, SIZE, CLASSES, steps=1,
                                        seed=3).epoch(0))
    imgs = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(labels).long().to(dev)
    loss, grads = {}, {}
    for dt_name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for impl in ("cuda", "torch"):
            loss[dt_name, impl], grads[dt_name, impl] = _param_grads(
                _model(dtype, impl, sd), imgs, labels, 7)
    ref = grads["fp32", "torch"]
    rel32, cos32 = _check_grad_tree("fp32 param grad", grads["fp32", "cuda"],
                                    ref, *PARAM_GRAD_TOL)
    dist = {impl: [float((grads["bf16", impl][n] - w).norm() / w.norm())
                   for n, w in ref.items()] for impl in ("cuda", "torch")}
    med16 = {impl: sorted(d)[len(d) // 2] for impl, d in dist.items()}
    if not med16["cuda"] <= BF16_GRAD_RATIO * med16["torch"] + 1e-3:
        raise AssertionError(
            f"bf16 param grads: the kernels' median leaf distance from the "
            f"fp32 plain gradients {med16['cuda']:.3e} exceeds "
            f"{BF16_GRAD_RATIO} x the plain scan's {med16['torch']:.3e}")
    grad_check = dict(
        loss={f"{d} {i}": v for (d, i), v in loss.items()},
        fp32_worst_rel=rel32, fp32_worst_cos=cos32, leaves=len(ref),
        bf16_median_dist=med16,
        bf16_max_dist={i: max(d) for i, d in dist.items()})

    step = make_train_step(model, opt, sched, state=state)
    x = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                      device=dev)
    y = torch.zeros(BATCH, dtype=torch.long, device=dev)
    # steps on a batch already on the card: no host data, no copy
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(x, y)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) / STEPS * 1e3
    rows = [r for r in _profile(lambda: step(x, y)) if r["cpu_us"] == 0.0]
    split = {"scan forward": "scan_fwd_kernel",
             "scan backward": "scan_bwd_kernel"}
    times = {k: sum(r["device_us"] for r in rows if pat in r["name"]) / 1e3
             for k, pat in split.items()}
    total_ms = sum(r["device_us"] for r in rows) / 1e3
    times["rest"] = total_ms - sum(times.values())
    rest = [r for r in rows
            if not any(p in r["name"] for p in split.values())]
    top = ", ".join(f"{r['name'][:40]} {r['device_us'] / 1e3:.2f} ms"
                    for r in rest[:4])
    gc = (f"fp32 loss {loss['fp32', 'cuda']:.6f} vs "
          f"{loss['fp32', 'torch']:.6f}, worst leaf rel-norm {rel32:.2e} "
          f"cos {cos32:.6f} over {len(ref)} leaves (tol {PARAM_GRAD_TOL}); "
          f"bf16 median (max) leaf distance from the fp32 plain gradients: "
          f"kernels {med16['cuda']:.3e} ({max(dist['cuda']):.3e}), plain "
          f"{med16['torch']:.3e} ({max(dist['torch']):.3e}), ratio "
          f"{med16['cuda'] / max(med16['torch'], 1e-30):.3f} (max "
          f"{BF16_GRAD_RATIO})")
    print(f"phase 4 medmamba {SIZE}x{SIZE} b{BATCH} bf16 training via "
          f"run_train, Adam 1e-4: {STEPS} steps after 1 warm-up, scan "
          f"launches fwd {launches[0]} bwd {launches[1]} ({launches[0] // STEPS}"
          f" + {launches[1] // STEPS} per step), loss {m['loss']:.4f} finite, "
          f"all {len(before)} parameters moved | train {m['img_s']:.2f} img/s "
          f"({m['seconds']:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | param grads kernel vs plain scan, "
          f"batch {GRAD_BATCH}: {gc} | step wall time: "
          f"{m['seconds'] / STEPS * 1e3:.2f} ms through run_train, "
          f"{resident_ms:.2f} ms on a batch already on the card | one step: "
          f"{total_ms:.2f} ms device time in kernels ("
          f"{100 * total_ms / resident_ms:.1f}% of the resident step): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; top of the rest: {top}", flush=True)
    return dict(launches_fwd=launches[0], launches_bwd=launches[1],
                loss=m["loss"], img_s=m["img_s"], seconds=m["seconds"],
                resident_step_ms=resident_ms, device_step_ms=total_ms,
                grad_check=grad_check, step_ms=times, profile=rows)


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
    bwd = phase_bwd_vs_plain()
    full = phase_full_model(card)
    train = phase_train(card)

    leaked = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "flax", "optax"))
                    or m.split(".")[0] == "medical_image_classification_tpu")
    if leaked:
        raise AssertionError(f"the port's path imported {leaked[:5]}")
    src = "medical_image_classification_tpu_torch/csrc/"
    jax_kernels = "medical_image_classification_tpu/kernels/"
    entries = []
    for name, replaces, case_list, launches in (
            ("selective_scan_fwd", "selective_scan_pallas_v2.py:36", cases,
             train["launches_fwd"]),
            ("selective_scan_bwd", "selective_scan_pallas_bwd_v2.py:57",
             bwd["cases"], train["launches_bwd"])):
        head = next(c for c in case_list
                    if c["L"] == STAGES[0][0] and c["dtype"] == "bf16"
                    and not c["reverse"])
        entries.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": jax_kernels + replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in case_list),
            "ms": head["ms"], "plain_ms": head["plain_ms"]})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, bwd=bwd, full_model=full,
                           train=train), f, indent=1)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
