#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device and build: the card's name and power limit (nvidia-smi), the
     twelve kernels compiled from csrc/ into build/torch_kernels/ (one nvcc
     each, all started together), with each kernel's registers, shared
     memory and spills as ptxas reports them;
  2. selective-scan forward kernel vs plain: MedMamba's four stage shapes
     (G 32, N 16), forward and reverse, fp32 and bf16: y, and the saved chunk
     states (xsave) the backward reads, with times from CUDA events;
  2b. selective-scan backward kernel vs plain, the same 16 cases, all seven
     gradients, a second launch bit-identical; at one shape ScanFolded's
     gradients against torch.autograd through the plain forward;
  2c. four-direction fused SSD forward kernel vs its plain twin at MedSSD's
     stages 0 and 1 (B 32; L 3136, l 224, H4 8 and L 784, l 196, H4 16;
     P 64, N 512) and its stage 0 at 240x240 (L 3600, l 240, nc 15, H4 8),
     fp32 and bf16: y and Ssave, times from CUDA events, and at each bf16
     case the device time of each of the walk's kernels (torch.profiler;
     so too in 2d, 2k and 2l);
  2d. its backward kernel vs the plain backward at the same 6 cases, all six
     cotangents, a second launch bit-identical; at stage 1 fp32,
     SSDFusedDirs against torch.autograd through the plain forward;
  2e. SSD Y_diag forward kernel vs plain at ST-SSD's stage 0 (BC 448 =
     32 x 14 chunks of l 224, H 8, N 64, P 64) and at N 512: MedSSD's
     stage 2 at 240x240 (BC 32, l 232 for L 225, H 32, P 64) and the shape
     of MedSSD's stage 3 at 512x512 (BC 32, l 256, H 64, P 64), fp32 and
     bf16;
  2f. STL token-mixer kernel vs plain at ST-SSD's stages 0 and 1 (BB 128;
     L = P 3136, C 128 and L = P 784, C 256), fp32 and bf16;
  2g. STF gate kernel vs plain at stages 0 and 1 (BB 32; P 3136, C 128 and
     P 784, C 256), fp32 and bf16; 2e-2g each with a second launch
     bit-identical and times from CUDA events;
  2h-2j. the backward kernels of Y_diag, the STL mixer and the STF gate
     against their plain backwards at the cases of 2e-2g, every cotangent,
     a second launch bit-identical, times from CUDA events; at one shape
     each (each Y_diag shape), YDiagFused, STLMixer and STFZGate against
     torch.autograd through the plain forward;
  2k. single-layout fused SSD forward kernel vs plain at MedSSD's stage 1
     at 240x240 (B 32, L 900 padded to 4 chunks of l 256, H 16, N 512,
     P 64) and at B 8, L 784 (4 chunks of l 196), H 8, N 128, P 64, fp32
     and bf16: y and Ssave, a second launch bit-identical;
  2l. its backward kernel vs the plain backward at the same 4 cases, all
     seven cotangents, a second launch bit-identical; SSDFused against
     torch.autograd through the plain forward in fp32 at both shapes;
  2m. selective-scan forward kernel with its state flags (init in, last
     out) vs plain at the Mamba LM's layer call (K 1, G 8, L 2048, Dm 1536)
     and MedMamba's stage 0 with its directions as groups (K 4, G 32),
     forward and reverse, fp32 and bf16: y, xsave and last, the first
     chunk's xsave equal to init, a second launch bit-identical, a zero
     init bit-identical to no init;
  2n. its backward with dlast and dinit at the same 8 cases, all eight
     gradients, a second launch bit-identical, a zero dlast bit-identical
     to none; ScanFolded with the flags against torch.autograd through the
     plain forward;
  3. medmamba eval and 4. medmamba training, 5. medssd eval and
     6. medssd training, 7. st_ssd eval and 8. st_ssd training, each model
     at full width (224x224), then 9. medssd eval and 10. medssd training
     at 240x240, where its stages take the dirs SSD, the single-layout
     fused SSD and Y_diag at N 512 (2 + 2 + 4 launches per forward); each
     at batch 32, 8 classes, seeded random weights with the scan
     parameters drawn away from init, bf16 compute, fp32 params.  Eval
     runs through cli.test.run_eval: every kernel's launches (each counter
     set to 0 just before the run and read just after: the path's kernels
     exactly their calls per forward, the others none), the logits
     against the same model with the plain versions (bf16, and fp32 on one
     batch), img/s and a profile of one forward.  Training runs through
     cli.train.run_train with Adam (lr 1e-4), one warm-up step then 4 timed
     steps: every kernel's launches (the path's forward and backward
     kernels exactly their calls per step, the others none), a finite loss,
     every parameter moved, every parameter's gradient at batch 4 against
     the plain versions (fp32 and bf16), img/s and a profile of one step;
  11. the Mamba-1 LM at mamba-130m width and depth (d_model 768, 24
     layers, vocab 50280, fp32, seeded random weights with the scan
     parameters drawn away from init) scoring 8 x 2048 tokens: 24 scan
     forward launches per forward and every other kernel none, the logits
     against the plain scan, tokens/s, device ms and the scan's share of
     one forward; then at 4 layers (b2 x 1024) every parameter's gradient
     of the cross-entropy plus a term on each layer's last state (dlast on
     the path), kernels against the plain scan;
  12. greedy generate with the full LM on the card (4 prompts x 64 tokens,
     32 new): each new token the full forward's argmax, decode_step's
     logits against the full forward's, ms per decode step and tokens/s.
Then one JSON line describing the twelve kernels (launches in the training
runs; errors, times, the bound of each from this run's shapes; times and
bounds at stage 0 in bf16, the fused SSD's at MedSSD's stage 1 at
240x240; rows 1-2 also at the LM's layer call under "lm"), the card's name
and power limit, and as the last line {"ok": true, "device": {...}}.  Without
a CUDA device it exits non-zero before printing any result.  ``--out``
writes the per-case numbers and the profiles as JSON.
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
KERNELS = ("selective_scan_fwd", "selective_scan_bwd", "ssd_fused_dirs_fwd",
           "ssd_fused_dirs_bwd", "ssd_ydiag_fwd", "ssd_ydiag_bwd",
           "stl_mixer_fwd", "stl_mixer_bwd", "stf_zgate_fwd", "stf_zgate_bwd",
           "ssd_fused_fwd", "ssd_fused_bwd")
# MedSSD's stages on the fused dirs path at 224x224: (L, chunk l, H4,
# d_ssm); P 64, gn 128 (N 512).  Stages 2-3 take the einsum path
SSD_STAGES = ((3136, 224, 8, 128), (784, 196, 16, 256))
# the dirs kernel's cases: those stages, and stage 0 at 240x240 (L 3600,
# chunk 240, nc 15)
SSD_CASES = SSD_STAGES + ((3600, 240, 8, 128),)
SSD_P, SSD_GN = 64, 128
# SSD kernels vs plain twin: |k - p| <= atol x max|p| + rtol |p|.  fp32
# differs in summation order (sums of up to l + N products); bf16 also
# where a rounded operand (M, dtx, S) or output lands one bf16 step from
# the plain twin's, the same rounding points on both sides
SSD_TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 2e-2)}
SSD_GRAD_TOL = {"fp32": (3e-3, 3e-3), "bf16": (6e-2, 3e-2)}
SSD_GRAD_NAMES = ("dstack", "dacum", "ddte", "dcdec", "ddtp", "dD")
MEDSSD_240 = 240                                    # PATHS says what runs
# the single-layout fused SSD's cases (B, L, chunk l, H, N), P 64: MedSSD
# 240x240 stage 1, padded as ssd_chunked pads it, and an in-window shape
# at the bottom of the chunk window with N 128
FUSED_CASES = ((BATCH, 900, 256, 16, 512), (8, 784, 196, 8, 128))
FUSED_GRAD_NAMES = ("dC", "dB", "dacum", "ddte", "dcdec", "ddtp", "dx")
# ST-SSD at 224x224 (d_state 16, N = 4 x 16 = 64, headdim 64): the Y_diag
# kernel's stage-0 shape (BC = B x 14 chunks, l 224, H 8 heads over the
# four directions); the (L = P, C) of the STL mixer (BB = 4 B, the
# directions folded in) and the STF gate (BB = B) at stages 0-1
ST_YDIAG = (BATCH * 14, 224, 8, 64, 64)             # BC, l, H, N, P
# Y_diag's cases (BC, l, H, N, P, L): ST-SSD's stage 0; at N 512 MedSSD's
# stage 2 at 240x240 (one chunk of 232 for L 225) and the shape MedSSD's
# stage 3 at 512x512 (and the fusion U-Nets) reach
YDIAG_CASES = (ST_YDIAG + (3136,), (BATCH, 232, 32, 512, 64, 225),
               (BATCH, 256, 64, 512, 64, 256))
ST_STAGES = ((3136, 128), (784, 256))
# ST kernels vs plain: |k - p| <= atol x max|p| + rtol |p|.  fp32 differs
# in summation order (sums of up to 3136 products; the mixer's softmax
# sum also rescales online); bf16 also where a rounded operand (M, E, Z)
# or output lands one bf16 step from the plain version's, the same
# rounding points on both sides
ST_TOL = {"fp32": (2e-3, 2e-3), "bf16": (3e-2, 2e-2)}
# their backward kernels vs the plain backwards, every cotangent, within
# the dirs SSD backward's tolerances: fp32 differs in summation order
# (dacum is a difference of row and column sums of G, du1 and dlz sum over
# the batch too); bf16 also where a rounded operand (M, E, dS, Z) or output
# lands one bf16 step away
ST_GRAD_TOL = SSD_GRAD_TOL
ST_GRAD_NAMES = {"ssd_ydiag": ("dCc", "dBc", "dacum", "ddtx"),
                 "stl_mixer": ("dw", "du1", "dV"),
                 "stf_zgate": ("dpooledT", "dlz", "dU")}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes
# per second, and operations per second by operand type (bf16 products on
# the tensor cores; fp32 on the CUDA cores, as the kernels and the plain
# versions compute fp32 without TF32)
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
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
# The Mamba-1 LM at mamba-130m width (models/mamba_lm.py MambaConfig's
# defaults: d_model 768, 24 layers, vocab 50277 padded to 50280, d_state
# 16, expand 2), fp32: scoring LM_BATCH x LM_LEN tokens; the gradient check
# at LM_GRAD_LAYERS layers on LM_GRAD_BATCH x LM_GRAD_LEN tokens; greedy
# generation of GEN_NEW tokens after GEN_PROMPTS prompts of GEN_PROMPT_LEN
LM_BATCH, LM_LEN, LM_LAYERS, LM_DINNER = 8, 2048, 24, 1536
LM_GRAD_BATCH, LM_GRAD_LEN, LM_GRAD_LAYERS = 2, 1024, 4
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 4, 64, 32
# the scan's flag cases (name, K, G, L, Dm): the LM's layer call (one
# group, G = batch) and MedMamba's stage 0 with its four directions as
# groups (G = 8 images x K 4)
FLAG_CASES = (("lm", 1, LM_BATCH, LM_LEN, LM_DINNER),
              ("medmamba0", 4, 32, 3136, 96))
# LM logits with the kernels vs the plain scan: |k - p| <= tol x max|p|
LM_LOGIT_TOL = 2e-3


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


def _ssd_cases():
    """The dirs SSD's cases, SSD_CASES in fp32 and bf16: (L, l, dtype
    name, args, d_ssm, dy), args the kernel's (stackr, acum, dte, cdec, dtp,
    Dsk) on the card, built as ssd_chunked_dirs builds them (dtp a softplus,
    acum its cumsum against A = -U(1, 4))."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (L, l, H4, d_ssm) in enumerate(SSD_CASES):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        nc = L // l
        C2 = 2 * (d_ssm + 2 * SSD_GN + H4 // 4)
        stack = 0.5 * rnd(BATCH, nc, l, C2)
        dtp = F.softplus(0.5 * rnd(BATCH, nc, H4, l) - 3.0)
        A = -(1.0 + 3.0 * torch.rand(H4, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A[:, None], dim=-1)
        dte = torch.exp(acum[..., -1:] - acum)
        cdec = torch.exp(acum[..., -1])
        D = 2.0 * torch.rand(H4, device=dev, generator=gen) - 1.0
        dy = rnd(BATCH, nc, l, H4 * SSD_P)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield L, l, dt_name, (stack.to(dtype).contiguous(), acum, dte,
                                  cdec, dtp, D), d_ssm, dy.to(dtype)


def _check_scaled(what, got, want, rtol, atol_rel):
    """|got - want| <= atol_rel max|want| + rtol |want|; returns the max
    abs error."""
    scale = max(float(want.float().abs().max()), 1e-30)
    return _check_close(what, got, want, rtol, atol_rel * scale)


def _walk_split(c, fn):
    """At a bf16 case, c["split"]: device ms of each kernel of the SSD
    chunk walk (scores, walks, intra, flush) in one call of ``fn``."""
    if c["dtype"] != "bf16":
        return
    rows = [r for r in _profile(fn) if r["cpu_us"] == 0.0]
    names = ("scores_kernel", "fwd_walk_kernel", "intra_kernel",
             "bwd_walk_kernel", "flush_kernel")
    c["split"] = {k: sum(r["device_us"] for r in rows if k in r["name"]) /
                  1e3 for k in names if any(k in r["name"] for r in rows)}


def _split_text(c):
    return "" if "split" not in c else " split " + " ".join(
        f"{k.replace('_kernel', '')}={v:.3f}ms" for k, v in c["split"].items())


def phase_ssd_fwd_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused_dirs as sfd)
    cases = []
    for L, l, dt_name, args, d_ssm, _ in _ssd_cases():
        run_k = lambda: sfd.ssd_fused_dirs_fwd(*args, d_ssm, SSD_GN,
                                               impl="cuda")
        run_p = lambda: sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, SSD_GN)
        yk = run_k()
        yk2, Sk = sfd.ssd_fused_dirs_fwd(*args, d_ssm, SSD_GN,
                                         want_save=True, impl="cuda")
        yp, Sp = sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, SSD_GN,
                                            want_save=True)
        torch.cuda.synchronize()
        what = f"SSD forward kernel vs plain L={L} l={l} {dt_name}"
        if not torch.equal(yk, yk2):
            raise AssertionError(f"{what}: y changes when Ssave is written")
        rtol, atol = SSD_TOL[dt_name]
        err = _check_scaled(what + " y", yk, yp, rtol, atol)
        serr = _check_scaled(what + " Ssave", Sk, Sp, rtol, atol)
        k_ms = _events_ms(run_k, 5)
        save_ms = _events_ms(lambda: sfd.ssd_fused_dirs_fwd(
            *args, d_ssm, SSD_GN, want_save=True, impl="cuda"), 5)
        p_ms = _events_ms(run_p, 2)
        cases.append(dict(L=L, l=l, dtype=dt_name, max_abs_err=err,
                          ssave_err=serr, y_max=float(yp.float().abs().max()),
                          ms=k_ms, save_ms=save_ms, plain_ms=p_ms,
                          bound=_ssd_bound(args, d_ssm, dt_name, False)))
        _walk_split(cases[-1], run_k)
    summary = "; ".join(
        f"{c['L']}/{c['l']} {c['dtype']} err={c['max_abs_err']:.2e} "
        f"(max|y| {c['y_max']:.1f}) Ssave_err={c['ssave_err']:.2e} "
        f"kernel={c['ms']:.3f}ms with_save={c['save_ms']:.3f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}){_split_text(c)}" for c in cases)
    print(f"phase 2c SSD dirs forward kernel vs plain: {len(cases)} cases "
          f"within {SSD_TOL} (rtol, atol x max|plain|), y and Ssave "
          f"(B={BATCH} P={SSD_P} N={4 * SSD_GN}) | {summary}", flush=True)
    return cases


def phase_ssd_bwd_vs_plain():
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused_dirs as sfd)
    cases = []
    for L, l, dt_name, args, d_ssm, dy in _ssd_cases():
        _, Ssave = sfd.ssd_fused_dirs_fwd_ref(*args, d_ssm, SSD_GN,
                                              want_save=True)
        run_k = lambda: sfd.ssd_fused_dirs_bwd(*args, d_ssm, SSD_GN, Ssave,
                                               dy, impl="cuda")
        run_p = lambda: sfd.ssd_fused_dirs_bwd_ref(*args, d_ssm, SSD_GN,
                                                   Ssave, dy)
        gk, gk2, gp = run_k(), run_k(), run_p()
        torch.cuda.synchronize()
        what = f"SSD backward kernel vs plain L={L} l={l} {dt_name}"
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        rtol, atol = SSD_GRAD_TOL[dt_name]
        errs = {nm: _check_scaled(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(SSD_GRAD_NAMES, gk, gp)}
        k_ms = _events_ms(run_k, 3)
        p_ms = _events_ms(run_p, 1)
        cases.append(dict(L=L, l=l, dtype=dt_name, errs=errs,
                          max_abs_err=max(errs.values()), ms=k_ms,
                          plain_ms=p_ms,
                          bound=_ssd_bound(args, d_ssm, dt_name, True)))
        _walk_split(cases[-1], run_k)

    # SSDFusedDirs (kernels) against torch.autograd through the plain
    # forward, at stage 1 in fp32
    L, l, dt_name, args, d_ssm, dy = next(
        c for c in _ssd_cases() if c[0] == SSD_STAGES[1][0]
        and c[2] == "fp32")
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    sfd.ssd_fused_dirs(*leaves, d_ssm, SSD_GN, impl="cuda").backward(dy)
    got = [a.grad for a in leaves]
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(
        sfd.ssd_fused_dirs_fwd_ref(*leaves, d_ssm, SSD_GN), leaves, dy)
    rtol, atol = SSD_GRAD_TOL[dt_name]
    auto_err = max(_check_scaled(f"SSDFusedDirs vs autograd {nm}", a, b,
                                 rtol, atol)
                   for nm, a, b in zip(SSD_GRAD_NAMES, got, want))
    summary = "; ".join(
        f"{c['L']}/{c['l']} {c['dtype']} " + " ".join(
            f"{k}={v:.2e}" for k, v in c["errs"].items())
        + f" kernel={c['ms']:.3f}ms plain={c['plain_ms']:.1f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]}){_split_text(c)}"
        for c in cases)
    print(f"phase 2d SSD dirs backward kernel vs plain: {len(cases)} cases "
          f"within {SSD_GRAD_TOL} (rtol, atol x max|plain|) on all 6 "
          f"cotangents, second launch bit-identical | SSDFusedDirs vs "
          f"torch.autograd through the plain forward at L={L} fp32: max err "
          f"{auto_err:.2e} | {summary}", flush=True)
    return dict(cases=cases, autograd_err=auto_err)


def _st_case(what, run_k, run_p, dt_name, reps):
    """One ST-SSD kernel case: two launches bit-identical, the kernel
    against its plain version within ST_TOL, times from CUDA events
    (``reps`` = kernel, plain repetitions)."""
    import torch
    yk, yk2, yp = run_k(), run_k(), run_p()
    torch.cuda.synchronize()
    if not torch.equal(yk, yk2):
        raise AssertionError(f"{what}: two launches differ in the bits")
    err = _check_scaled(what, yk, yp, *ST_TOL[dt_name])
    out_max = float(yp.float().abs().max())
    del yk, yk2, yp
    return dict(dtype=dt_name, max_abs_err=err, out_max=out_max,
                ms=_events_ms(run_k, reps[0]),
                plain_ms=_events_ms(run_p, reps[1]))


def _st_summary(cases):
    return "; ".join(
        f"{c['shape']} {c['dtype']} err={c['max_abs_err']:.2e} (max|out| "
        f"{c['out_max']:.2f}) kernel={c['ms']:.3f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]})" for c in cases)


def _ydiag_cases():
    """Y_diag's cases (YDIAG_CASES), fp32 and bf16: (shape, dtype name,
    (Cc, Bc, acum, dtx), dy), built as ssd_chunked builds them (acum the
    cumsum of softplus steps against A = -U(1, 4); at L < l the padded
    steps carry dt = 0 and zero operands)."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (BC, l, H, N, P, L) in enumerate(YDIAG_CASES):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        live = (torch.arange(l, device=dev) < L).float()
        Cc = 0.5 * rnd(BC, l, N) * live[:, None]
        Bc = 0.5 * rnd(BC, l, N) * live[:, None]
        dtp = F.softplus(0.5 * rnd(BC, H, l) - 3.0) * live
        A = -(1.0 + 3.0 * torch.rand(H, 1, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A, dim=-1)
        dtx, dy = rnd(BC, H, l, P), rnd(BC, H, l, P)
        shape = dict(L=L, shape=f"BC{BC} l{l} H{H} N{N} P{P}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield shape, dt_name, (Cc.to(dtype), Bc.to(dtype), acum,
                                   dtx.to(dtype)), dy.to(dtype)


def _ydiag_bound(args, dt_name, backward):
    """Bytes of the operands in and the outputs out; the products over the
    causal (i, j <= i) pairs: forward the scores 2 pairs N and per head
    2 pairs P; backward the scores, dC and dB 6 pairs N and per head ddtx
    and dM 4 pairs P."""
    Cc, _, acum, dtx = args
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    isz = Cc.element_size()
    pairs = l * (l + 1) // 2
    cb, rows, heads = 2 * BC * l * N * isz, BC * H * l * 4, BC * H * l * P * isz
    if not backward:
        return _bound(cb + rows + 2 * heads,
                      BC * (2 * pairs * N + H * 2 * pairs * P), dt_name)
    return _bound(2 * cb + 2 * rows + 3 * heads,
                  BC * (6 * pairs * N + H * 4 * pairs * P), dt_name)


def phase_ydiag_vs_plain():
    """2e: the Y_diag kernel at ST-SSD's stage 0 and at N 512."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_ydiag as yd)
    cases = []
    for shape, dt_name, args, _ in _ydiag_cases():
        c = _st_case(f"Y_diag kernel vs plain {shape['shape']} {dt_name}",
                     lambda: yd.ydiag_fused_fwd(*args, impl="cuda"),
                     lambda: yd.ydiag_fused_ref(*args), dt_name, (5, 2))
        c.update(shape, bound=_ydiag_bound(args, dt_name, False))
        cases.append(c)
    print(f"phase 2e Y_diag forward kernel vs plain: {len(cases)}/"
          f"{2 * len(YDIAG_CASES)} cases within {ST_TOL} (rtol, atol x "
          f"max|plain|), second launch bit-identical | "
          f"{_st_summary(cases)}", flush=True)
    return cases


def _stl_cases():
    """The STL mixer's cases at ST-SSD's stages 0-1 (BB = 4 B, the
    directions folded in; u1 and u2 U[0, 1) as at init, V = w u2), fp32
    and bf16: (stage, L, C, dtype name, (w, u1, V), dU)."""
    import torch
    dev = torch.device("cuda")
    BB = 4 * BATCH
    for i, (L, C) in enumerate(ST_STAGES):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        w = 0.5 * torch.randn(BB, L, C, device=dev, generator=gen)
        u1 = torch.rand(C, L, device=dev, generator=gen)
        u2 = torch.rand(C, C, device=dev, generator=gen)
        dU = torch.randn(BB, L, C, device=dev, generator=gen)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            wd = w.to(dtype)
            yield i, L, C, dt_name, (wd, u1.to(dtype), wd @ u2.to(dtype)), \
                dU.to(dtype)


def _stl_bound(args, dt_name, backward):
    """Bytes of w, u1, V in and U out (backward: w, u1, V, dU in and dw,
    du1, dV out); products 4 BB L P C (backward: the TPU body's five,
    10 BB L P C)."""
    w, u1, _ = args
    BB, L, C = w.shape
    P = u1.shape[1]
    isz = w.element_size()
    if not backward:
        return _bound((2 * BB * L * C + BB * P * C + C * P) * isz,
                      4 * BB * L * P * C, dt_name)
    return _bound((4 * BB * L * C + BB * P * C + 2 * C * P) * isz,
                  10 * BB * L * P * C, dt_name)


def phase_stl_vs_plain():
    """2f: the STL mixer kernel at ST-SSD's stages 0-1."""
    from medical_image_classification_tpu_torch.kernels import (
        stl_mixer as stl)
    cases = []
    for i, L, C, dt_name, args, _ in _stl_cases():
        reps = (2, 1) if dt_name == "fp32" and i == 0 else (5, 2)
        c = _st_case(f"STL mixer kernel vs plain L=P={L} C={C} {dt_name}",
                     lambda: stl.stl_mixer_fwd(*args, impl="cuda"),
                     lambda: stl.stl_mixer_fwd_ref(*args), dt_name, reps)
        c.update(L=L, shape=f"BB{4 * BATCH} L=P{L} C{C}",
                 bound=_stl_bound(args, dt_name, False))
        cases.append(c)
        del args
    print(f"phase 2f STL mixer forward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_TOL} (rtol, atol x max|plain|), second launch "
          f"bit-identical | {_st_summary(cases)}", flush=True)
    return cases


def _stf_cases():
    """The STF gate's cases at stages 0-1 (BB = B; lz U[0, 1) as at init),
    fp32 and bf16: (stage, P, C, dtype name, (pooledT, lz, U), dY)."""
    import torch
    dev = torch.device("cuda")
    for i, (P, C) in enumerate(ST_STAGES):
        gen = torch.Generator(device=dev).manual_seed(400 + i)
        pT = 0.5 * torch.randn(BATCH, P, C, device=dev, generator=gen)
        lz = torch.rand(C, P, device=dev, generator=gen)
        U = torch.randn(BATCH, P, C, device=dev, generator=gen)
        dY = torch.randn(BATCH, P, C, device=dev, generator=gen)
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield i, P, C, dt_name, (pT.to(dtype), lz.to(dtype),
                                     U.to(dtype)), dY.to(dtype)


def _stf_bound(args, dt_name, backward):
    """Bytes of pooledT, lz, U in and Y out (backward: pooledT, lz, U, dY
    in and dpooledT, dlz, dU out); products 4 BB P^2 C (backward: the TPU
    body's five, 10 BB P^2 C)."""
    pT, _, _ = args
    BB, P, C = pT.shape
    isz = pT.element_size()
    if not backward:
        return _bound((3 * BB * P * C + C * P) * isz, 4 * BB * P * P * C,
                      dt_name)
    return _bound((5 * BB * P * C + 2 * C * P) * isz, 10 * BB * P * P * C,
                  dt_name)


def phase_stf_vs_plain():
    """2g: the STF gate kernel at ST-SSD's stages 0-1."""
    from medical_image_classification_tpu_torch.kernels import (
        stf_zgate as stf)
    cases = []
    for i, P, C, dt_name, args, _ in _stf_cases():
        c = _st_case(f"STF gate kernel vs plain P={P} C={C} {dt_name}",
                     lambda: stf.stf_zgate_fwd(*args, impl="cuda"),
                     lambda: stf.stf_zgate_fwd_ref(*args), dt_name, (5, 2))
        c.update(L=P, shape=f"BB{BATCH} P{P} C{C}",
                 bound=_stf_bound(args, dt_name, False))
        cases.append(c)
    print(f"phase 2g STF gate forward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_TOL} (rtol, atol x max|plain|), second launch "
          f"bit-identical | {_st_summary(cases)}", flush=True)
    return cases


def _st_bwd_case(what, names, run_k, run_p, dt_name, reps,
                 tol=ST_GRAD_TOL):
    """One backward case: two launches bit-identical, every cotangent
    against the plain backward within ``tol``, times from CUDA events
    (``reps`` = kernel, plain repetitions)."""
    import torch
    gk, gk2, gp = run_k(), run_k(), run_p()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
        raise AssertionError(f"{what}: two launches differ in the bits")
    errs = {nm: _check_scaled(f"{what} {nm}", a, b, *tol[dt_name])
            for nm, a, b in zip(names, gk, gp)}
    scales = {nm: float(b.float().abs().max()) for nm, b in zip(names, gp)}
    del gk, gk2, gp
    return dict(dtype=dt_name, errs=errs, plain_max=scales,
                max_abs_err=max(errs.values()),
                ms=_events_ms(run_k, reps[0]),
                plain_ms=_events_ms(run_p, reps[1]))


def _vs_autograd(what, names, run_fn, run_ref, args, grad_out,
                 tol=ST_GRAD_TOL):
    """A Function on the card against torch.autograd through the plain
    forward (fp32, ``tol``): the max abs error over the cotangents."""
    import torch
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    run_fn(*leaves).backward(grad_out)
    got = [a.grad for a in leaves]
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(run_ref(*leaves), leaves, grad_out)
    return max(_check_scaled(f"{what} vs autograd {nm}", a, b,
                             *tol["fp32"])
               for nm, a, b in zip(names, got, want))


def _st_bwd_summary(cases):
    return "; ".join(
        f"{c['shape']} {c['dtype']} " + " ".join(
            f"{k}={v:.2e} (max|plain| {c['plain_max'][k]:.3g})"
            for k, v in c["errs"].items())
        + f" kernel={c['ms']:.3f}ms plain={c['plain_ms']:.2f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]})" for c in cases)


def phase_ydiag_bwd_vs_plain():
    """2h: the Y_diag backward kernel at 2e's cases; YDiagFused against
    torch.autograd in fp32 at each shape."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_ydiag as yd)
    names = ST_GRAD_NAMES["ssd_ydiag"]
    cases, auto = [], 0.0
    for shape, dt_name, args, dy in _ydiag_cases():
        c = _st_bwd_case(
            f"Y_diag backward kernel vs plain {shape['shape']} {dt_name}",
            names, lambda: yd.ydiag_fused_bwd(*args, dy, impl="cuda"),
            lambda: yd.ydiag_fused_bwd_ref(*args, dy), dt_name, (5, 2))
        c.update(shape, bound=_ydiag_bound(args, dt_name, True))
        cases.append(c)
        if dt_name == "fp32":
            auto = max(auto, _vs_autograd(
                "YDiagFused", names,
                lambda *a: yd.ydiag_fused(*a, impl="cuda"),
                yd.ydiag_fused_ref, args, dy))
    print(f"phase 2h Y_diag backward kernel vs plain: {len(cases)}/"
          f"{2 * len(YDIAG_CASES)} cases within {ST_GRAD_TOL} (rtol, atol x "
          f"max|plain|) on all 4 cotangents, second launch bit-identical | "
          f"YDiagFused vs torch.autograd through the plain forward, fp32, "
          f"worst of {len(YDIAG_CASES)} shapes: max err {auto:.2e} | "
          f"{_st_bwd_summary(cases)}", flush=True)
    return dict(cases=cases, autograd_err=auto)


def phase_stl_bwd_vs_plain():
    """2i: the STL mixer backward kernel at 2f's cases; STLMixer against
    torch.autograd at stage 1 in fp32."""
    from medical_image_classification_tpu_torch.kernels import (
        stl_mixer as stl)
    names = ST_GRAD_NAMES["stl_mixer"]
    cases = []
    for i, L, C, dt_name, args, dU in _stl_cases():
        reps = (2, 1) if dt_name == "fp32" and i == 0 else (3, 1)
        c = _st_bwd_case(
            f"STL mixer backward kernel vs plain L=P={L} C={C} {dt_name}",
            names, lambda: stl.stl_mixer_bwd(*args, dU, impl="cuda"),
            lambda: stl.stl_mixer_bwd_ref(*args, dU), dt_name, reps)
        c.update(L=L, shape=f"BB{4 * BATCH} L=P{L} C{C}",
                 bound=_stl_bound(args, dt_name, True))
        cases.append(c)
        if i == 1 and dt_name == "fp32":
            auto = _vs_autograd(
                "STLMixer", names,
                lambda *a: stl.STLMixer.apply(*a, "cuda"),
                stl.stl_mixer_fwd_ref, args, dU)
        del args, dU
    print(f"phase 2i STL mixer backward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_GRAD_TOL} (rtol, atol x max|plain|) on all 3 "
          f"cotangents, second launch bit-identical | STLMixer vs "
          f"torch.autograd through the plain forward at stage 1 fp32: max "
          f"err {auto:.2e} | {_st_bwd_summary(cases)}", flush=True)
    return dict(cases=cases, autograd_err=auto)


def phase_stf_bwd_vs_plain():
    """2j: the STF gate backward kernel at 2g's cases; STFZGate against
    torch.autograd at stage 1 in fp32."""
    from medical_image_classification_tpu_torch.kernels import (
        stf_zgate as stf)
    names = ST_GRAD_NAMES["stf_zgate"]
    cases = []
    for i, P, C, dt_name, args, dY in _stf_cases():
        c = _st_bwd_case(
            f"STF gate backward kernel vs plain P={P} C={C} {dt_name}",
            names, lambda: stf.stf_zgate_bwd(*args, dY, impl="cuda"),
            lambda: stf.stf_zgate_bwd_ref(*args, dY), dt_name, (5, 2))
        c.update(L=P, shape=f"BB{BATCH} P{P} C{C}",
                 bound=_stf_bound(args, dt_name, True))
        cases.append(c)
        if i == 1 and dt_name == "fp32":
            auto = _vs_autograd(
                "STFZGate", names,
                lambda *a: stf.stf_zgate(*a, impl="cuda"),
                stf.stf_zgate_fwd_ref, args, dY)
    print(f"phase 2j STF gate backward kernel vs plain: {len(cases)}/4 cases "
          f"within {ST_GRAD_TOL} (rtol, atol x max|plain|) on all 3 "
          f"cotangents, second launch bit-identical | STFZGate vs "
          f"torch.autograd through the plain forward at stage 1 fp32: max "
          f"err {auto:.2e} | {_st_bwd_summary(cases)}", flush=True)
    return dict(cases=cases, autograd_err=auto)


def _fused_cases():
    """The single-layout fused SSD's cases (FUSED_CASES), fp32 and bf16:
    (case dict, dtype name, (Cc, Bc, acum, dte, cdec, dtp, x), dy), built
    as ssd_chunked builds them: the steps a softplus, padded with dt = 0
    and zero operands up to whole chunks (after the softplus), acum their
    cumsum against A = -U(1, 4), dte and cdec from it; dy is zero on the
    padded steps, which ssd_chunked slices off."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    for i, (B, L, l, H, N) in enumerate(FUSED_CASES):
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        nc = -(-L // l)
        live = (torch.arange(nc * l, device=dev) < L).float()[:, None]
        steps = lambda *s: (rnd(B, nc * l, *s) * live).reshape(
            B, nc, l, *s)
        dtp = F.softplus(steps(H) * 0.5 - 3.0) * live.reshape(nc, l, 1)
        dtp = dtp.transpose(2, 3).contiguous()               # [B, nc, H, l]
        A = -(1.0 + 3.0 * torch.rand(H, 1, device=dev, generator=gen))
        acum = torch.cumsum(dtp * A, dim=-1)
        dte = torch.exp(acum[..., -1:] - acum)
        cdec = torch.exp(acum[..., -1])
        C, Bm = 0.5 * steps(N), 0.5 * steps(N)
        x, dy = steps(H * SSD_P), steps(H * SSD_P)
        case = dict(L=L, l=l, shape=f"B{B} L{L} nc{nc} l{l} H{H} "
                    f"N{N} P{SSD_P}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            yield case, dt_name, (C.to(dtype), Bm.to(dtype), acum, dte, cdec,
                                  dtp, x.to(dtype)), dy.to(dtype)


def phase_fused_fwd_vs_plain():
    """2k: the single-layout fused SSD forward kernel vs its plain version:
    y and Ssave, y unchanged when Ssave is written, a second launch
    bit-identical, times from CUDA events."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused as sf)
    cases = []
    for case, dt_name, args, _ in _fused_cases():
        run_k = lambda: sf.ssd_fused_fwd(*args, impl="cuda")
        run_p = lambda: sf.ssd_fused_fwd_ref(*args)
        yk, yk2 = run_k(), run_k()
        yk3, Sk = sf.ssd_fused_fwd(*args, want_save=True, impl="cuda")
        yp, Sp = sf.ssd_fused_fwd_ref(*args, want_save=True)
        torch.cuda.synchronize()
        what = f"fused SSD forward kernel vs plain {case['shape']} {dt_name}"
        if not (torch.equal(yk, yk2) and torch.equal(yk, yk3)):
            raise AssertionError(f"{what}: y differs between launches or "
                                 "when Ssave is written")
        rtol, atol = SSD_TOL[dt_name]
        err = _check_scaled(what + " y", yk, yp, rtol, atol)
        serr = _check_scaled(what + " Ssave", Sk, Sp, rtol, atol)
        y_max = float(yp.float().abs().max())
        del yk, yk2, yk3, Sk, yp, Sp
        cases.append(dict(case, dtype=dt_name, max_abs_err=max(err, serr),
                          y_err=err, ssave_err=serr, y_max=y_max,
                          ms=_events_ms(run_k, 5),
                          save_ms=_events_ms(lambda: sf.ssd_fused_fwd(
                              *args, want_save=True, impl="cuda"), 5),
                          plain_ms=_events_ms(run_p, 2),
                          bound=_fused_bound(args, dt_name, False)))
        _walk_split(cases[-1], run_k)
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} err={c['y_err']:.2e} (max|y| "
        f"{c['y_max']:.1f}) Ssave_err={c['ssave_err']:.2e} "
        f"kernel={c['ms']:.3f}ms with_save={c['save_ms']:.3f}ms "
        f"plain={c['plain_ms']:.2f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]}){_split_text(c)}" for c in cases)
    print(f"phase 2k fused SSD forward kernel vs plain: {len(cases)}/"
          f"{2 * len(FUSED_CASES)} cases within {SSD_TOL} (rtol, atol x "
          f"max|plain|), y and Ssave, second launch bit-identical | "
          f"{summary}", flush=True)
    return cases


def phase_fused_bwd_vs_plain():
    """2l: the single-layout fused SSD backward kernel vs the plain
    backward at 2k's cases, all seven cotangents, a second launch
    bit-identical; SSDFused against torch.autograd through the plain
    forward in fp32 at each shape."""
    from medical_image_classification_tpu_torch.kernels import (
        ssd_fused as sf)
    cases, auto = [], 0.0
    for case, dt_name, args, dy in _fused_cases():
        _, Ssave = sf.ssd_fused_fwd_ref(*args, want_save=True)
        run_k = lambda: sf.ssd_fused_bwd(*args, Ssave, dy, impl="cuda")
        c = _st_bwd_case(
            f"fused SSD backward kernel vs plain {case['shape']} {dt_name}",
            FUSED_GRAD_NAMES, run_k,
            lambda: sf.ssd_fused_bwd_ref(*args, Ssave, dy), dt_name, (3, 1),
            SSD_GRAD_TOL)
        c.update(case, bound=_fused_bound(args, dt_name, True))
        _walk_split(c, run_k)
        cases.append(c)
        del Ssave
        if dt_name == "fp32":
            auto = max(auto, _vs_autograd(
                "SSDFused", FUSED_GRAD_NAMES,
                lambda *a: sf.ssd_fused(*a, impl="cuda"),
                sf.ssd_fused_fwd_ref, args, dy, SSD_GRAD_TOL))
    print(f"phase 2l fused SSD backward kernel vs plain: {len(cases)}/"
          f"{2 * len(FUSED_CASES)} cases within {SSD_GRAD_TOL} (rtol, atol x "
          f"max|plain|) on all 7 cotangents, second launch bit-identical | "
          f"SSDFused vs torch.autograd through the plain forward, fp32, "
          f"worst of {len(FUSED_CASES)} shapes: max err {auto:.2e} | "
          + "; ".join(_st_bwd_summary([c]) + _split_text(c) for c in cases),
          flush=True)
    return dict(cases=cases, autograd_err=auto)


def _flag_cases():
    """The scan's flag cases, FLAG_CASES in fp32 and bf16, forward and
    reverse: (case dict, dtype name, reverse, args, init), args the folded
    scan's (u, delta, A, B, C, D, bias) on the card with S4D-real A =
    -(1..N), init [G, N, Dm] fp32."""
    import torch
    dev = torch.device("cuda")
    for i, (name, K, g, L, Dm) in enumerate(FLAG_CASES):
        gen = torch.Generator(device=dev).manual_seed(700 + i)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        base = dict(u=rnd(g, L, Dm), delta=0.5 * rnd(g, L, Dm),
                    B=rnd(g, L, N), C=rnd(g, L, N))
        A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
            K, Dm, N).contiguous()
        D, bias, init = rnd(K, Dm), 0.1 * rnd(K, Dm), rnd(g, N, Dm)
        case = dict(name=name, K=K, G=g, L=L, Dm=Dm,
                    shape=f"{name} K{K} G{g} L{L} Dm{Dm} N{N}")
        for dt_name, dtype in (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)):
            act = {k: v.to(dtype) for k, v in base.items()}
            for reverse in (False, True):
                yield case, dt_name, reverse, (
                    act["u"], act["delta"], A, act["B"], act["C"], D,
                    bias), init


def phase_scan_fwd_flags():
    """2m: the scan forward kernel with its state flags (init in, last
    out) vs the plain version: y, xsave and last within the row-1 ladder
    (TOL), the first scanned chunk's xsave equal to init, a second launch
    bit-identical, and with a zero init y equal to the flag-free launch's
    bits; times of the kernel with the flags and without, from CUDA
    events."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_fwd as fwd)
    cases = []
    for case, dt_name, reverse, args, init in _flag_cases():
        what = f"forward flags {case['shape']} {dt_name} reverse={reverse}"
        run_k = lambda: fwd._launch_cuda(*args, reverse, True,
                                         want_state=True, init=init)
        run_0 = lambda: fwd._launch_cuda(*args, reverse, True)
        run_p = lambda: fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                                want_state=True, init=init)
        yk, xk, lk = fwd._launch_cuda(*args, reverse, True, want_xsave=True,
                                      want_state=True, init=init)
        yk2, lk2 = run_k()
        y0 = run_0()
        yz, _ = fwd._launch_cuda(*args, reverse, True, want_state=True,
                                 init=torch.zeros_like(init))
        yp, xp, lp = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                             want_xsave=True,
                                             want_state=True, init=init)
        torch.cuda.synchronize()
        if not (torch.equal(yk, yk2) and torch.equal(lk, lk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        if not torch.equal(yz, y0):
            raise AssertionError(f"{what}: a zero init changes y")
        if not torch.equal(xk[:, -1 if reverse else 0], init):
            raise AssertionError(f"{what}: the first chunk's xsave is not "
                                 "init")
        rtol, atol = TOL[dt_name]
        errs = dict(y=_check_close(what + " y", yk, yp, rtol, atol),
                    xsave=_check_close(what + " xsave", xk, xp, rtol, atol),
                    last=_check_close(what + " last", lk, lp, rtol, atol))
        del yk, xk, lk, yk2, lk2, y0, yz, yp, xp, lp
        cases.append(dict(case, dtype=dt_name, reverse=reverse, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 10),
                          eval_ms=_events_ms(run_0, 10),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_scan_bound(case["L"], case["Dm"], dt_name,
                                            False, case["G"], True)))
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'} "
        + " ".join(f"{k}={v:.2e}" for k, v in c["errs"].items())
        + f" kernel={c['ms']:.4f}ms without_flags={c['eval_ms']:.4f}ms "
        f"plain={c['plain_ms']:.1f}ms bound={c['bound'][0]:.4f}ms "
        f"({c['bound'][1]})" for c in cases)
    print(f"phase 2m forward kernel with init and last vs plain: "
          f"{len(cases)}/{4 * len(FLAG_CASES)} cases within "
          f"fp32 {TOL['fp32']} bf16 {TOL['bf16']} (rtol, atol) on y, "
          f"xsave and last, the first chunk's xsave = init, second launch "
          f"bit-identical, a zero init bit-identical to no init | {summary}",
          flush=True)
    return cases


def phase_scan_bwd_flags():
    """2n: the scan backward kernel with its state flags (dlast seeding
    the adjoint, dinit out) vs the plain backward at 2m's cases, all eight
    gradients within the row-2 ladder (GRAD_TOL), a second launch
    bit-identical, a zero dlast bit-identical to no dlast; ScanFolded with
    want_state and init against torch.autograd through the plain forward
    at MedMamba's stage-2 shape (K 4), fp32, both directions."""
    import torch
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as bwd, selective_scan_fwd as fwd)
    names = GRAD_NAMES + ("dinit",)
    cases = []
    for case, dt_name, reverse, args, init in _flag_cases():
        what = f"backward flags {case['shape']} {dt_name} reverse={reverse}"
        _, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                           want_xsave=True, init=init)
        gen = torch.Generator(device="cuda").manual_seed(case["L"] + reverse)
        dy = torch.randn(args[0].shape, device="cuda",
                         generator=gen).to(args[0].dtype)
        dlast = torch.randn(init.shape, device="cuda", generator=gen)
        run_k = lambda: bwd.scan_folded_bwd(*args, xsave, dy,
                                            reverse=reverse, impl="cuda",
                                            dlast=dlast, want_dinit=True)
        run_p = lambda: bwd.scan_folded_bwd_ref(*args, xsave, dy,
                                                reverse=reverse, dlast=dlast,
                                                want_dinit=True)
        gk, gk2, gp = run_k(), run_k(), run_p()
        g0 = bwd.scan_folded_bwd(*args, xsave, dy, reverse=reverse,
                                 impl="cuda")
        gz = bwd.scan_folded_bwd(*args, xsave, dy, reverse=reverse,
                                 impl="cuda", dlast=torch.zeros_like(dlast))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"{what}: two launches differ in the bits")
        if not all(torch.equal(a, b) for a, b in zip(g0, gz)):
            raise AssertionError(f"{what}: a zero dlast changes a gradient")
        rtol, atol = GRAD_TOL[dt_name]
        errs = {nm: _check_close(f"{what} {nm}", a, b, rtol, atol)
                for nm, a, b in zip(names, gk, gp)}
        del gk, gk2, gp, g0, gz
        cases.append(dict(case, dtype=dt_name, reverse=reverse, errs=errs,
                          max_abs_err=max(errs.values()),
                          ms=_events_ms(run_k, 5),
                          plain_ms=_events_ms(run_p, 1),
                          bound=_scan_bound(case["L"], case["Dm"], dt_name,
                                            True, case["G"], True)))

    # ScanFolded with the flags (kernels) against torch.autograd through
    # the plain forward, the loss reading y and the last state
    L, Dm, K, g = STAGES[2][0], STAGES[2][1], 4, G
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    A = -torch.arange(1, N + 1, device="cuda",
                      dtype=torch.float32).expand(K, Dm, N).contiguous()
    args = (rnd(g, L, Dm), 0.5 * rnd(g, L, Dm), A, rnd(g, L, N),
            rnd(g, L, N), rnd(K, Dm), 0.1 * rnd(K, Dm), rnd(g, N, Dm))
    wy, wl = rnd(g, L, Dm), rnd(g, N, Dm)
    auto = 0.0
    for reverse in (False, True):
        def grads(fn):
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            y, last = fn(*leaves[:7], reverse=reverse, want_state=True,
                         init=leaves[7])
            return torch.autograd.grad((y * wy).sum() + (last * wl).sum(),
                                       leaves)
        got = grads(lambda *a, **kw: fwd.scan_folded_fwd(*a, impl="cuda",
                                                         **kw))
        want = grads(fwd.scan_folded_fwd_ref)
        auto = max([auto] + [
            _check_close(f"ScanFolded with flags vs autograd {nm} "
                         f"reverse={reverse}", a, b, *GRAD_TOL["fp32"])
            for nm, a, b in zip(names, got, want)])
    summary = "; ".join(
        f"{c['shape']} {c['dtype']} {'rev' if c['reverse'] else 'fwd'} "
        f"err={c['max_abs_err']:.2e} (dinit {c['errs']['dinit']:.2e}) "
        f"kernel={c['ms']:.4f}ms plain={c['plain_ms']:.1f}ms "
        f"bound={c['bound'][0]:.4f}ms ({c['bound'][1]})" for c in cases)
    print(f"phase 2n backward kernel with dlast and dinit vs plain: "
          f"{len(cases)}/{4 * len(FLAG_CASES)} cases within fp32 "
          f"{GRAD_TOL['fp32']} bf16 {GRAD_TOL['bf16']} (rtol, atol) on all "
          f"8 gradients, second launch bit-identical, a zero dlast "
          f"bit-identical to none | ScanFolded with want_state and init vs "
          f"torch.autograd through the plain forward at {L}x{Dm} K{K} fp32, "
          f"both directions: max err {auto:.2e} | {summary}", flush=True)
    return dict(cases=cases, autograd_err=auto)


def _bound(nbytes, ops, dtype):
    """The least time of the work on this card: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _walk_bound(operand_bytes, B, nc, l, H, P, N, isz, dtype, backward):
    """The chunk walk's least time (the dirs and the single-layout fused
    SSD): bytes each input read once and each output written once (the
    operands x, B, C of ``operand_bytes``; the fp32 rows acum, dte, dtp and
    cdec; y; backward: the operands, rows, Ssave and dy in, their
    cotangents out), and the products the function needs over the causal
    pairs j <= i of a chunk, l (l + 1) / 2 of them (per chunk: scores
    2 pairs N; per head 2 pairs P + 4 l N P forward; the backward
    recomputes the scores and adds dscores' two products, 4 pairs P +
    10 l N P per head)."""
    pairs = l * (l + 1) // 2
    rows = 3 * B * nc * H * l * 4 + B * nc * H * 4
    y = B * nc * l * H * P * isz
    if not backward:
        nbytes = operand_bytes + rows + y
        ops = B * nc * (2 * pairs * N + H * (2 * pairs * P + 4 * l * N * P))
    else:
        ssave = B * nc * H * P * N * isz
        nbytes = 2 * operand_bytes + 2 * rows + ssave + y
        ops = B * nc * (3 * 2 * pairs * N
                        + H * (4 * pairs * P + 10 * l * N * P))
    return _bound(nbytes, ops, dtype)


def _ssd_bound(args, d_ssm, dtype, backward):
    """The dirs SSD's bound (``_walk_bound``; the operands are the stack)."""
    stack, acum = args[0], args[1]
    B, nc, l, _ = stack.shape
    H4 = acum.shape[2]
    return _walk_bound(stack.numel() * stack.element_size(), B, nc, l, H4,
                       d_ssm // (H4 // 4), 4 * SSD_GN, stack.element_size(),
                       dtype, backward)


def _fused_bound(args, dtype, backward):
    """The single-layout fused SSD's bound (``_walk_bound``; the operands
    are C, B and x)."""
    Cc, Bc, acum, x = args[0], args[1], args[2], args[6]
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    isz = Cc.element_size()
    return _walk_bound((Cc.numel() + Bc.numel() + x.numel()) * isz, B, nc, l,
                       H, x.shape[3] // H, N, isz, dtype, backward)


def _scan_bound(L, Dm, dtype, backward, g=G, flags=False):
    """The selective scan at ``g`` sequences: bytes of u, Δ, B, C in and y
    out (backward: also dy and xsave in, du, dΔ, dB, dC out; with the
    ``flags``, init in and last out, or dlast in and dinit out, fp32), and
    ~7 fp32 operations per state per step forward (~20 backward: the state
    recompute and the adjoint), on the CUDA cores."""
    isz = 4 if dtype == "fp32" else 2
    seq = g * L * (3 * Dm + 2 * N) * isz       # u, Δ, B, C and y (or dy)
    ops = (20 if backward else 7) * g * L * Dm * N
    states = 2 * g * N * Dm * 4 if flags else 0
    if backward:
        xsave = g * -(-L // 32) * N * Dm * 4
        out = g * L * (2 * Dm + 2 * N) * isz     # du, dΔ, dB, dC
        return _bound(seq + xsave + out + states, ops, "fp32")
    return _bound(seq + states, ops, "fp32")


def _perturb_scan_params(model, gen):
    """Draw the scan parameters away from their init, so that the logit
    checks see the state term: at init D = 1 and Δ is small, so each scan
    output rounds back to its input in bf16."""
    import torch
    from medical_image_classification_tpu_torch.models.ss2d_modules import (
        SS2D, SS2DSSD)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SS2D):
                m.Ds.uniform_(-1.0, 1.0, generator=gen)
                dt = torch.empty(m.dt_projs_bias.shape).uniform_(
                    0.05, 0.5, generator=gen)
                m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.x_proj_weight.mul_(4.0)
            elif isinstance(m, SS2DSSD):
                m.Ds.uniform_(-1.0, 1.0, generator=gen)
                dt = torch.empty(m.dt_bias.shape).uniform_(
                    0.05, 0.5, generator=gen)
                m.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.A_logs.copy_(torch.empty(m.A_logs.shape).uniform_(
                    1.0, 16.0, generator=gen).log())


def _model(name, dtype, scan_impl, state_dict=None):
    """Seeded ``name`` on the card, in eval mode; without ``state_dict``
    its scan parameters are drawn away from init."""
    import torch
    from medical_image_classification_tpu_torch.models import create_model
    gen = torch.Generator().manual_seed(0)
    model = create_model(name, CLASSES, dtype=dtype, scan_impl=scan_impl,
                         generator=gen)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        _perturb_scan_params(model, gen)
    return model.cuda().eval()


def _counters():
    """Every kernel's wrapper by kernel name; each carries the count of its
    launches (``.launches``)."""
    from medical_image_classification_tpu_torch.kernels import (
        selective_scan_bwd as ssb, selective_scan_fwd as ssf,
        ssd_fused as sf, ssd_fused_dirs as sfd, ssd_ydiag as yd,
        stf_zgate as stf, stl_mixer as stl)
    return {"selective_scan_fwd": ssf.scan_folded_fwd,
            "selective_scan_bwd": ssb.scan_folded_bwd,
            "ssd_fused_dirs_fwd": sfd.ssd_fused_dirs_fwd,
            "ssd_fused_dirs_bwd": sfd.ssd_fused_dirs_bwd,
            "ssd_ydiag_fwd": yd.ydiag_fused_fwd,
            "ssd_ydiag_bwd": yd.ydiag_fused_bwd,
            "stl_mixer_fwd": stl.stl_mixer_fwd,
            "stl_mixer_bwd": stl.stl_mixer_bwd,
            "stf_zgate_fwd": stf.stf_zgate_fwd,
            "stf_zgate_bwd": stf.stf_zgate_bwd,
            "ssd_fused_fwd": sf.ssd_fused_fwd,
            "ssd_fused_bwd": sf.ssd_fused_bwd}


# What the model phases count and split, by (model, image size): {forward
# kernel: launches per model forward} (in training each forward kernel's
# backward, named *_bwd, launches as often) and {profile share: kernel name
# patterns}.  At 240x240 medssd runs the walk kernels of both layouts, which
# share their names; the layout type in the kernel's name tells them apart
PATHS = {
    ("medmamba", SIZE): (
        {"selective_scan_fwd": SCAN_CALLS_PER_FORWARD},
        {"scan forward": ("scan_fwd_kernel",),
         "scan backward": ("scan_bwd_kernel",)}),
    ("medssd", SIZE): (
        {"ssd_fused_dirs_fwd": 2 + 2},               # blocks of stages 0-1
        {"ssd scores": ("scores_kernel",),
         "ssd forward": ("fwd_walk_kernel",),
         "ssd backward": ("intra_kernel", "bwd_walk_kernel",
                          "flush_kernel")}),
    # Y_diag in stage 0's two blocks, the mixer and the gate in the blocks
    # of stages 0-1
    ("st_ssd", SIZE): (
        {"ssd_ydiag_fwd": 2, "stl_mixer_fwd": 4, "stf_zgate_fwd": 4},
        {"ssd ydiag": ("ydiag_kernel",),
         "ssd ydiag backward": ("ydiag_grad_kernel", "ydiag_dcb_kernel"),
         "stl mixer": ("stats_kernel", "mix_kernel"),
         "stl mixer backward": ("mix_rows_bwd_kernel",
                                "mix_cols_bwd_kernel"),
         "stf gate": ("zgate_kernel",),
         "stf gate backward": ("gate_rows_bwd_kernel",
                               "gate_cols_bwd_kernel")}),
    # stage 0 (L 3600) takes the dirs SSD at chunk 240, stage 1 (L 900, no
    # pad-free chunk in the dirs window) the single-layout fused SSD at
    # chunk 256 over 4 chunks, the last padded (900 -> 1024), stage 2 (L 225,
    # one chunk of 232) Y_diag at N 512, stage 3 the einsums: launches per
    # forward = the stages' depths
    ("medssd", MEDSSD_240): (
        {"ssd_fused_dirs_fwd": 2, "ssd_fused_fwd": 2, "ssd_ydiag_fwd": 4},
        {"ssd dirs": ("DirsLayout",),
         "ssd fused": ("FlatLayout",),
         "ssd ydiag": ("ydiag_kernel",),
         "ssd ydiag backward": ("ydiag_grad_kernel", "ydiag_dcb_kernel")}),
}


def _path(name, size=SIZE):
    """PATHS' entry for model ``name`` at ``size`` pixels a side."""
    if (name, size) not in PATHS:
        raise ValueError(f"chip_smoke has no path for {name} at {size}")
    return PATHS[(name, size)]


def _launches(counters):
    return {k: c.launches for k, c in counters.items()}


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


def phase_full_model(card, name, num, size=SIZE):
    import torch
    from medical_image_classification_tpu_torch.cli.test import run_eval
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    calls, split = _path(name, size)
    counters = _counters()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    model = _model(name, bf16, "auto")
    run_eval(model, SyntheticLoader(BATCH, size, CLASSES, steps=1, seed=1),
             dev)                                      # warm-up
    loader = SyntheticLoader(BATCH, size, CLASSES, steps=STEPS, seed=0)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    n_correct, labels, logits = run_eval(model, loader, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(counters)
    want = {k: calls.get(k, 0) * STEPS for k in counters}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches in {STEPS} forwards "
                             f"{launches}, expected {want}")
    if logits.shape != (BATCH * STEPS, CLASSES):
        raise AssertionError(f"logits shape {logits.shape}")
    img_s = BATCH * STEPS / seconds

    # the same weights with the plain versions, on the first batch
    sd = model.state_dict()
    one = SyntheticLoader(BATCH, size, CLASSES, steps=1, seed=0)
    _, _, ref16 = run_eval(_model(name, bf16, "torch", sd), one, dev)
    err16 = _check_logits("bf16", logits[:BATCH], ref16, LOGIT_TOL["bf16"])
    _, _, k32 = run_eval(_model(name, None, "cuda", sd), one, dev)
    _, _, ref32 = run_eval(_model(name, None, "torch", sd), one, dev)
    err32 = _check_logits("fp32", k32, ref32, LOGIT_TOL["fp32"])
    after = {k: want[k] + calls.get(k, 0) for k in counters}
    if _launches(counters) != after:
        raise AssertionError(f"the plain models launched a kernel, or the "
                             f"fp32 kernel model did not launch its own: "
                             f"{_launches(counters)}, expected {after}")

    from medical_image_classification_tpu_torch.train.eval_step import (
        make_eval_step)
    step = make_eval_step(model)
    x = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                      device=dev)
    y = torch.zeros(BATCH, dtype=torch.long, device=dev)
    # forwards on a batch already on the card: no host data, no copy
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(x, y)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) / STEPS * 1e3
    prof_rows = _profile(lambda: step(x, y))
    kernel_us = [r for r in prof_rows if r["cpu_us"] == 0.0]
    total_ms = sum(r["device_us"] for r in kernel_us) / 1e3
    hit = lambda r, pats: any(p in r["name"] for p in pats)
    times = {k: sum(r["device_us"] for r in kernel_us if hit(r, pats)) / 1e3
             for k, pats in split.items()}
    times["rest"] = total_ms - sum(times.values())
    top = ", ".join(f"{r['name'][:48]} {r['device_us'] / 1e3:.2f} ms"
                    for r in kernel_us[:4])
    per_fwd = ", ".join(f"{k} {v} ({v // STEPS} per forward)"
                        for k, v in launches.items() if v)
    print(f"phase {num} {name} {size}x{size} b{BATCH} bf16 via run_eval: "
          f"{STEPS} batches, kernel launches {per_fwd}, the other kernels "
          f"none; logits {logits.shape} finite "
          f"| kernel vs plain logits max err bf16 {err16:.3e} "
          f"(tol {LOGIT_TOL['bf16']} x max|logit|), fp32 {err32:.3e} "
          f"(tol {LOGIT_TOL['fp32']} x max|logit|) | eval {img_s:.2f} img/s "
          f"({seconds:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | forward wall time on a batch "
          f"already on the card {resident_ms:.2f} ms | one forward: "
          f"{total_ms:.2f} ms device time in kernels ("
          f"{100 * total_ms / resident_ms:.1f}% of the resident forward): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; top: {top}", flush=True)
    return dict(launches=launches, img_s=img_s, seconds=seconds,
                logit_err_bf16=err16, logit_err_fp32=err32,
                top1=n_correct / len(labels), device_forward_ms=total_ms,
                resident_forward_ms=resident_ms, forward_ms=times,
                profile=prof_rows)


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


def phase_train(card, name, num, size=SIZE):
    import math

    import torch
    from medical_image_classification_tpu_torch.cli.train import run_train
    from medical_image_classification_tpu_torch.data.loader import (
        SyntheticLoader)
    from medical_image_classification_tpu_torch.train.optim import (
        make_lr_scheduler, make_optimizer, make_schedule)
    from medical_image_classification_tpu_torch.train.train_step import (
        TrainState, make_train_step)
    calls, split = _path(name, size)
    pairs = {f: f[:-len("fwd")] + "bwd" for f in calls}
    counters = _counters()
    want = {k: 0 for k in counters}
    for f, b in pairs.items():
        want[f] = want[b] = calls[f] * STEPS
    dev = torch.device("cuda")
    model = _model(name, torch.bfloat16, "auto")
    model.seed_drop_path(1)
    opt = make_optimizer("adam", model.named_parameters())
    sched = make_lr_scheduler(opt, make_schedule("constant", 1e-4))
    state = TrainState()
    run_train(model, opt, sched, SyntheticLoader(BATCH, size, CLASSES,
                                                 steps=1, seed=1), dev,
              state=state)                              # warm-up
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = SyntheticLoader(BATCH, size, CLASSES, steps=STEPS, seed=2)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    m = run_train(model, opt, sched, loader, dev, state=state)
    launches = _launches(counters)
    if launches != want:
        raise AssertionError(f"{name}: kernel launches in {STEPS} train "
                             f"steps {launches}, expected {want}")
    if not math.isfinite(m["loss"]) or state.step != 1 + STEPS:
        raise AssertionError(f"train loss {m['loss']}, step {state.step}")
    still = sorted(n for n, p in model.named_parameters()
                   if torch.equal(p, before[n]))
    if still:
        raise AssertionError(f"{len(still)} parameters did not move in "
                             f"{STEPS} Adam steps: {still[:5]}")

    # every parameter's gradient: kernels against the plain versions, same
    # weights, same batch of GRAD_BATCH, same DropPath masks
    sd = model.state_dict()
    imgs, labels = next(SyntheticLoader(GRAD_BATCH, size, CLASSES, steps=1,
                                        seed=3).epoch(0))
    imgs = torch.from_numpy(imgs).to(dev)
    labels = torch.from_numpy(labels).long().to(dev)
    loss, grads = {}, {}
    for dt_name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        for impl in ("cuda", "torch"):
            loss[dt_name, impl], grads[dt_name, impl] = _param_grads(
                _model(name, dtype, impl, sd), imgs, labels, 7)
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
            f"{BF16_GRAD_RATIO} x the plain versions' {med16['torch']:.3e}")
    grad_check = dict(
        loss={f"{d} {i}": v for (d, i), v in loss.items()},
        fp32_worst_rel=rel32, fp32_worst_cos=cos32, leaves=len(ref),
        bf16_median_dist=med16,
        bf16_max_dist={i: max(d) for i, d in dist.items()})

    step = make_train_step(model, opt, sched, state=state)
    x = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
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
    hit = lambda r, pats: any(p in r["name"] for p in pats)
    times = {k: sum(r["device_us"] for r in rows if hit(r, pats)) / 1e3
             for k, pats in split.items()}
    total_ms = sum(r["device_us"] for r in rows) / 1e3
    times["rest"] = total_ms - sum(times.values())
    rest = [r for r in rows if not any(hit(r, p) for p in split.values())]
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
    per_step = ", ".join(f"{f} + {b} {launches[f]} + {launches[b]} "
                         f"({launches[f] // STEPS} + {launches[b] // STEPS} "
                         f"per step)" for f, b in pairs.items())
    print(f"phase {num} {name} {size}x{size} b{BATCH} bf16 training via "
          f"run_train, Adam 1e-4: {STEPS} steps after 1 warm-up, kernel "
          f"launches {per_step}, the other kernels none, loss "
          f"{m['loss']:.4f} finite, "
          f"all {len(before)} parameters moved | train {m['img_s']:.2f} img/s "
          f"({m['seconds']:.3f} s for {BATCH * STEPS} images, host data and "
          f"copies included) on {card} | param grads kernels vs plain, "
          f"batch {GRAD_BATCH}: {gc} | step wall time: "
          f"{m['seconds'] / STEPS * 1e3:.2f} ms through run_train, "
          f"{resident_ms:.2f} ms on a batch already on the card | one step: "
          f"{total_ms:.2f} ms device time in kernels ("
          f"{100 * total_ms / resident_ms:.1f}% of the resident step): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items())
          + f"; top of the rest: {top}", flush=True)
    return dict(launches=launches, loss=m["loss"], img_s=m["img_s"], seconds=m["seconds"],
                resident_step_ms=resident_ms, device_step_ms=total_ms,
                grad_check=grad_check, step_ms=times, profile=rows)


def _lm_model(n_layer, scan_impl="auto"):
    """Seeded mamba-130m (``n_layer`` of its 24 layers) on the card in
    eval mode, its scan parameters drawn away from init so that the logit
    checks see the state term: D ~ U(-1, 1), Δ's bias the softplus-inverse
    of U(0.05, 0.5), A_log = log U(1, 16), x_proj's weight (B, C and Δ's
    rank) times 4."""
    import torch
    from medical_image_classification_tpu_torch.models.mamba_lm import (
        Mamba, MambaConfig, MambaLMHeadModel)
    gen = torch.Generator().manual_seed(0)
    model = MambaLMHeadModel(MambaConfig(n_layer=n_layer),
                             scan_impl=scan_impl, generator=gen)
    draw = lambda t, lo, hi: torch.empty(t.shape).uniform_(lo, hi,
                                                           generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Mamba):
                m.D.copy_(draw(m.D, -1.0, 1.0))
                dt = draw(m.dt_proj.bias, 0.05, 0.5)
                m.dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.A_log.copy_(draw(m.A_log, 1.0, 16.0).log())
                m.x_proj.weight.mul_(4.0)
    return model.eval()


def _set_scan_impl(model, impl):
    from medical_image_classification_tpu_torch.models.mamba_lm import Mamba
    for m in model.modules():
        if isinstance(m, Mamba):
            m.scan_impl = impl


def _lm_tokens(batch, length, seed, vocab=50277):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (batch, length), device="cuda",
                         generator=gen)


def _lm_state_loss(model, ids):
    """The LM's forward with every mixer returning its last state: the
    next-token cross-entropy, and the sum over the layers of each last
    state's mean square over its own (constant) value: a term worth 1 per
    layer whatever the states' scale, so that the scan's dlast carries
    weight on the gradient's path."""
    import torch.nn.functional as F
    bb = model.backbone
    h, states = bb.embedding(ids), 0.0
    for blk in bb.layers:
        y, last = blk.mixer(blk.norm(h), return_state=True)
        h = h + y
        sq = last.square().mean()
        states = states + sq / sq.detach()
    logits = model.lm_head(bb.norm_f(h))
    ce = F.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())
    return ce, states


def phase_lm_scoring(card):
    """11: the Mamba-1 LM at mamba-130m width and depth, fp32, scoring
    LM_BATCH x LM_LEN tokens: the kernel launches of one forward (the scan
    forward once per layer, every other kernel none), the logits against
    the same model with the plain scan, tokens/s (host clock over
    forwards ending in a synchronize), the device time of one forward and
    the scan's share of it (torch.profiler); then the gradient check at
    LM_GRAD_LAYERS layers: every parameter's gradient of the cross-entropy
    plus the last states' term (``_lm_state_loss``), kernels against the
    plain scan, and the launches of that step."""
    import torch
    import torch.nn.functional as F
    counters = _counters()
    model = _lm_model(LM_LAYERS)
    ids = _lm_tokens(LM_BATCH, LM_LEN, 1)
    with torch.no_grad():
        model(ids[:, :64])                                  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        logits = model(ids)
        torch.cuda.synchronize()
        launches = _launches(counters)
        want = {k: LM_LAYERS if k == "selective_scan_fwd" else 0
                for k in counters}
        if launches != want:
            raise AssertionError(f"LM forward: kernel launches {launches}, "
                                 f"expected {want}")
        V = logits.shape[-1]
        if logits.shape != (LM_BATCH, LM_LEN, V) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"LM logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        nll = float(F.cross_entropy(logits[:, :-1].flatten(0, 1),
                                    ids[:, 1:].flatten()))
        t0 = time.perf_counter()
        for _ in range(STEPS):
            model(ids)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) / STEPS * 1e3
        rows = [r for r in _profile(lambda: model(ids))
                if r["cpu_us"] == 0.0]
        device_ms = sum(r["device_us"] for r in rows) / 1e3
        scan_ms = sum(r["device_us"] for r in rows
                      if "scan_fwd_kernel" in r["name"]) / 1e3
        _set_scan_impl(model, "torch")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        plain = model(ids)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        scale = float(plain.abs().max())
        err = float((logits - plain).abs().max())
        if err > LM_LOGIT_TOL * scale:
            raise AssertionError(f"LM logits kernel vs plain scan max err "
                                 f"{err:.3e} > {LM_LOGIT_TOL} x {scale:.3f}")
        plain_nll = float(F.cross_entropy(plain[:, :-1].flatten(0, 1),
                                          ids[:, 1:].flatten()))
        if any(_launches(counters).values()):
            raise AssertionError("the plain-scan LM launched a kernel")
        del logits, plain
    top = ", ".join(f"{r['name'][:40]} {r['device_us'] / 1e3:.2f} ms"
                    for r in rows[:4])
    tokens_s = LM_BATCH * LM_LEN / fwd_ms * 1e3
    print(f"phase 11 LM scoring (mamba-130m: d_model 768, {LM_LAYERS} "
          f"layers, vocab {V}, fp32) b{LM_BATCH} x {LM_LEN} tokens: kernel "
          f"launches selective_scan_fwd {launches['selective_scan_fwd']} "
          f"per forward, the other kernels none; logits finite, mean NLL "
          f"{nll:.4f} (plain scan {plain_nll:.4f}) | kernel vs plain-scan "
          f"logits max err {err:.3e} (tol {LM_LOGIT_TOL} x max|logit| "
          f"{scale:.3f}) | {tokens_s:.1f} tokens/s, {fwd_ms:.2f} ms per "
          f"forward (host clock, {STEPS} forwards) on {card}; the plain-scan "
          f"forward {plain_s:.2f} s | one forward: {device_ms:.2f} ms device "
          f"time in kernels ({100 * device_ms / fwd_ms:.1f}% of the "
          f"forward), the scan {scan_ms:.2f} ms "
          f"({100 * scan_ms / device_ms:.1f}%); top: {top}", flush=True)
    del model
    torch.cuda.empty_cache()

    # the gradient check, at LM_GRAD_LAYERS layers
    model = _lm_model(LM_GRAD_LAYERS)
    ids = _lm_tokens(LM_GRAD_BATCH, LM_GRAD_LEN, 2)
    model.train()
    grads, losses = {}, {}
    for impl in ("cuda", "torch"):
        _set_scan_impl(model, impl)
        model.zero_grad(set_to_none=True)
        for c in counters.values():
            c.launches = 0
        ce, states = _lm_state_loss(model, ids)
        (ce + states).backward()
        torch.cuda.synchronize()
        got = _launches(counters)
        n = LM_GRAD_LAYERS if impl == "cuda" else 0
        want = {k: n if k in ("selective_scan_fwd", "selective_scan_bwd")
                else 0 for k in counters}
        if got != want:
            raise AssertionError(f"LM gradient step ({impl}): kernel "
                                 f"launches {got}, expected {want}")
        losses[impl] = (float(ce.detach()), float(states.detach()))
        grads[impl] = {nm: p.grad.detach().double().flatten()
                       for nm, p in model.named_parameters()}
    rel, cos = _check_grad_tree("LM param grad", grads["cuda"],
                                grads["torch"], *PARAM_GRAD_TOL)
    # every leaf, the abs floor aside (fp32: the leaves may all fall under it)
    diffs = {nm: float((grads["cuda"][nm] - w).norm())
             for nm, w in grads["torch"].items()}
    rel_all = max(d / (float(grads["torch"][nm].norm()) + 1e-30)
                  for nm, d in diffs.items())
    print(f"phase 11 LM gradient check ({LM_GRAD_LAYERS} layers, full "
          f"width, b{LM_GRAD_BATCH} x {LM_GRAD_LEN}, fp32, every mixer "
          f"returning its last state): launches selective_scan_fwd + bwd "
          f"{LM_GRAD_LAYERS} + {LM_GRAD_LAYERS}, the other kernels none; "
          f"loss (cross-entropy, last-state term) kernels "
          f"{losses['cuda'][0]:.6f}, {losses['cuda'][1]:.6f} vs plain "
          f"{losses['torch'][0]:.6f}, {losses['torch'][1]:.6f}; worst leaf "
          f"rel-norm {rel:.2e} cos {cos:.6f} over {len(grads['torch'])} "
          f"leaves (tol {PARAM_GRAD_TOL}); without the floor: worst leaf "
          f"rel-norm {rel_all:.2e}, largest error norm "
          f"{max(diffs.values()):.2e}", flush=True)
    del model, grads
    torch.cuda.empty_cache()
    return dict(launches_per_forward=launches["selective_scan_fwd"],
                tokens_s=tokens_s, forward_ms=fwd_ms,
                device_forward_ms=device_ms, scan_ms=scan_ms,
                scan_share=scan_ms / device_ms, logit_err=err,
                logit_scale=scale, nll=nll, plain_nll=plain_nll,
                plain_forward_s=plain_s, grad_worst_rel=rel,
                grad_worst_cos=cos, grad_worst_rel_no_floor=rel_all,
                grad_losses=losses, profile=rows)


def phase_lm_generate(card):
    """12: greedy generation on the card with the full-depth LM:
    GEN_PROMPTS prompts of GEN_PROMPT_LEN tokens and GEN_NEW new tokens
    through ``generate`` (prefill and decoding through decode_step, plain
    torch ops: no kernel launches); each new token equal to the argmax of
    the full forward (the scan kernel) over the generated sequence, and
    decode_step's logits over that sequence against the full forward's;
    decode ms per token and new tokens/s (host clock)."""
    import torch
    from medical_image_classification_tpu_torch.models.mamba_lm import (
        generate)
    counters = _counters()
    model = _lm_model(LM_LAYERS)
    prompts = _lm_tokens(GEN_PROMPTS, GEN_PROMPT_LEN, 3)
    generate(model, prompts[:, :2], 2)                      # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = generate(model, prompts, GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = sum(_launches(counters).values())
    if gen_launches or out.shape != (GEN_PROMPTS, GEN_PROMPT_LEN + GEN_NEW):
        raise AssertionError(f"generate: {gen_launches} kernel launches, "
                             f"tokens {tuple(out.shape)}")
    with torch.no_grad():
        full = model(out)
        fwd_launches = _launches(counters)["selective_scan_fwd"]
        if fwd_launches != LM_LAYERS:
            raise AssertionError(f"full forward: {fwd_launches} scan "
                                 f"launches, expected {LM_LAYERS}")
        pred = full[:, GEN_PROMPT_LEN - 1:-1].argmax(-1)
        same = int((pred == out[:, GEN_PROMPT_LEN:]).sum())
        if same != GEN_PROMPTS * GEN_NEW:
            raise AssertionError(f"generate: {same} of {GEN_PROMPTS * GEN_NEW}"
                                 " new tokens equal the full forward's "
                                 "argmax")
        top2 = full[:, GEN_PROMPT_LEN - 1:-1].topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        cache = model.init_cache(GEN_PROMPTS)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(out.shape[1]):
            logits, cache = model.decode_step(out[:, t], cache)
            steps.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / out.shape[1] * 1e3
        dec = torch.stack(steps, dim=1)
        scale = float(full.abs().max())
        err = float((dec - full).abs().max())
        if err > LM_LOGIT_TOL * scale:
            raise AssertionError(f"decode_step vs full forward logits max err "
                                 f"{err:.3e} > {LM_LOGIT_TOL} x {scale:.3f}")
    steps_run = GEN_PROMPT_LEN + GEN_NEW - 1
    tokens_s = GEN_PROMPTS * GEN_NEW / gen_s
    print(f"phase 12 LM generate (mamba-130m, fp32, greedy): {GEN_PROMPTS} "
          f"prompts x {GEN_PROMPT_LEN} tokens + {GEN_NEW} new in "
          f"{gen_s:.3f} s ({steps_run} decode steps, "
          f"{gen_s / steps_run * 1e3:.2f} ms per step, {tokens_s:.1f} new "
          f"tokens/s) on {card}, no kernel launches; all {same} new tokens "
          f"equal the full forward's argmax (smallest top-2 margin "
          f"{margin:.3e}; the forward {fwd_launches} scan launches) | "
          f"decode_step over the {out.shape[1]} tokens vs the full forward: "
          f"logits max err {err:.3e} (tol {LM_LOGIT_TOL} x max|logit| "
          f"{scale:.3f}), {step_ms:.2f} ms per step", flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(seconds=gen_s, tokens_s=tokens_s,
                ms_per_step=gen_s / steps_run * 1e3,
                decode_loop_ms_per_step=step_ms, tokens_equal=same,
                top2_margin=margin, decode_logit_err=err)


def _entry(name, replaces, cases, launches, head, bound):
    """One kernel's record for the kernels line; ``head`` picks the case
    whose times it reports."""
    c = next(c for c in cases if head(c))
    return {"name": name, "route": "cuda",
            "source": f"medical_image_classification_tpu_torch/csrc/{name}.cu",
            "replaces": f"medical_image_classification_tpu/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


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
    ssd_cases = phase_ssd_fwd_vs_plain()
    ssd_bwd = phase_ssd_bwd_vs_plain()
    yd_cases = phase_ydiag_vs_plain()
    stl_cases = phase_stl_vs_plain()
    stf_cases = phase_stf_vs_plain()
    yd_bwd = phase_ydiag_bwd_vs_plain()
    stl_bwd = phase_stl_bwd_vs_plain()
    stf_bwd = phase_stf_bwd_vs_plain()
    fused_cases = phase_fused_fwd_vs_plain()
    fused_bwd = phase_fused_bwd_vs_plain()
    flag_cases = phase_scan_fwd_flags()
    flag_bwd = phase_scan_bwd_flags()
    full = phase_full_model(card, "medmamba", 3)
    train = phase_train(card, "medmamba", 4)
    ssd_full = phase_full_model(card, "medssd", 5)
    ssd_train = phase_train(card, "medssd", 6)
    st_full = phase_full_model(card, "st_ssd", 7)
    st_train = phase_train(card, "st_ssd", 8)
    ssd240_full = phase_full_model(card, "medssd", 9, MEDSSD_240)
    ssd240_train = phase_train(card, "medssd", 10, MEDSSD_240)
    lm = phase_lm_scoring(card)
    lm_gen = phase_lm_generate(card)

    leaked = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith(("jax.", "flax", "optax"))
                    or m.split(".")[0] == "medical_image_classification_tpu")
    if leaked:
        raise AssertionError(f"the port's path imported {leaked[:5]}")
    # launches in the training runs; times and bounds at stage 0 in bf16
    # (the forward scan's direction 0)
    scan_head = lambda c: (c["L"] == STAGES[0][0] and c["dtype"] == "bf16"
                           and not c["reverse"])
    ssd_head = lambda c: c["L"] == SSD_STAGES[0][0] and c["dtype"] == "bf16"
    st_head = lambda c: c["L"] == ST_STAGES[0][0] and c["dtype"] == "bf16"
    fused_head = lambda c: c["L"] == FUSED_CASES[0][1] and \
        c["dtype"] == "bf16"
    entries = [
        _entry("selective_scan_fwd", "selective_scan_pallas_v2.py:36",
               cases + flag_cases, train["launches"]["selective_scan_fwd"],
               scan_head, _scan_bound(*STAGES[0], "bf16", False)),
        _entry("selective_scan_bwd", "selective_scan_pallas_bwd_v2.py:57",
               bwd["cases"] + flag_bwd["cases"],
               train["launches"]["selective_scan_bwd"], scan_head,
               _scan_bound(*STAGES[0], "bf16", True))]
    # rows 1-2 also at the LM's layer call (fp32, forward scan, flags on),
    # with the LM's launches: per scoring forward, per gradient step
    lm_head = lambda c: c.get("name") == "lm" and c["dtype"] == "fp32" \
        and not c["reverse"]
    for e, fc, per in ((entries[0], flag_cases,
                        dict(per_forward=lm["launches_per_forward"])),
                       (entries[1], flag_bwd["cases"],
                        dict(per_grad_step=LM_GRAD_LAYERS))):
        c = next(c for c in fc if lm_head(c))
        e["lm"] = dict(per, shape=c["shape"], dtype="fp32", ms=c["ms"],
                       plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                       bound_by=c["bound"][1])
    for name, replaces, st_cases, head, launches in (
            ("ssd_fused_dirs_fwd", "ssd_fused_dirs_pallas.py:178", ssd_cases,
             ssd_head, ssd_train),
            ("ssd_fused_dirs_bwd", "ssd_fused_dirs_pallas.py:240",
             ssd_bwd["cases"], ssd_head, ssd_train),
            ("ssd_ydiag_fwd", "ssd_ydiag_pallas.py:153", yd_cases, st_head,
             st_train),
            ("ssd_ydiag_bwd", "ssd_ydiag_pallas.py:174", yd_bwd["cases"],
             st_head, st_train),
            ("stl_mixer_fwd", "stl_mixer_pallas.py:85", stl_cases, st_head,
             st_train),
            ("stl_mixer_bwd", "stl_mixer_pallas.py:107", stl_bwd["cases"],
             st_head, st_train),
            ("stf_zgate_fwd", "stf_zgate_pallas.py:76", stf_cases, st_head,
             st_train),
            ("stf_zgate_bwd", "stf_zgate_pallas.py:85", stf_bwd["cases"],
             st_head, st_train),
            ("ssd_fused_fwd", "ssd_fused_pallas.py:139", fused_cases,
             fused_head, ssd240_train),
            ("ssd_fused_bwd", "ssd_fused_pallas.py:193", fused_bwd["cases"],
             fused_head, ssd240_train)):
        entries.append(_entry(name, replaces, st_cases,
                              launches["launches"][name], head,
                              next(c for c in st_cases if head(c))["bound"]))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, bwd=bwd,
                           ssd_cases=ssd_cases, ssd_bwd=ssd_bwd,
                           ydiag_cases=yd_cases, stl_cases=stl_cases,
                           stf_cases=stf_cases, ydiag_bwd=yd_bwd,
                           stl_bwd=stl_bwd, stf_bwd=stf_bwd,
                           fused_cases=fused_cases, fused_bwd=fused_bwd,
                           full_model=full, train=train,
                           medssd_eval=ssd_full, medssd_train=ssd_train,
                           st_ssd_eval=st_full, st_ssd_train=st_train,
                           medssd240_eval=ssd240_full,
                           medssd240_train=ssd240_train,
                           flag_cases=flag_cases, flag_bwd=flag_bwd,
                           lm_scoring=lm, lm_generate=lm_gen),
                      f, indent=1)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
