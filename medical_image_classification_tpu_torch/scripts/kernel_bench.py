"""Microbenchmark of the selective-scan kernels on one NVIDIA GPU.

    python -m medical_image_classification_tpu_torch.scripts.kernel_bench \\
        [--stage all|0|1|2|3] [--iters N] [--t-cap T] \\
        [--vmem-budget-mb MB] [--calibrate]

Port of ``scripts/kernel_bench.py``: times the folded scan's forward and
forward + backward at the MedMamba-T stage shapes (G 128 = batch 32 x 4
directions, N 16, bf16 operands, fp32 parameters) through the folded entry
(``kernels/selective_scan_fwd.py::scan_folded_fwd``), with the dispatch of
the JAX package's folded entry: ``--t-cap`` and ``--vmem-budget-mb`` set the
tile chooser's cap and budget (``kernels/selective_scan_v1.py``), and where
they give a chunk T that is not a multiple of 8 the scan runs the v1
kernels (``--t-cap 50``: every stage; ``--t-cap 100``: stages 0-1).
``--calibrate`` times the calibration floor (``kernels/scan_calib.py``: the
scan's per-element work without the scan) instead; ``CALIB_BF16=1`` rounds
its arithmetic to bf16.  ``--impl`` names the dispatch ("cuda", or
"pallas" as the JAX script names it), the one there is.  Times are CUDA
events over ``--iters`` calls after one warm-up call, each call ending in
the sum of its outputs as the JAX script's does.  Needs a CUDA device;
nothing runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from medical_image_classification_tpu_torch.kernels import (
    scan_calib as calib_mod,
    selective_scan_fwd as fwd,
    selective_scan_v1 as v1,
)

# MedMamba-T SS2D shapes per stage at batch 32 (G = B*K = 128)
STAGES = {
    "0": dict(G=128, L=3136, Dm=96, N=16),
    "1": dict(G=128, L=784, Dm=192, N=16),
    "2": dict(G=128, L=196, Dm=384, N=16),
    "3": dict(G=128, L=49, Dm=768, N=16),
}


def make_inputs(G, L, Dm, N, dtype=torch.bfloat16, K=4, device="cpu"):
    """The JAX script's inputs, bit for bit: numpy's RandomState(0) in the
    same order, float64 -> float32 -> ``dtype`` for the activations, fp32
    parameters."""
    rng = np.random.RandomState(0)

    def to(a, dt):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dt)
    u = to(rng.randn(G, L, Dm), dtype)
    delta = to(0.1 * rng.randn(G, L, Dm), dtype)
    A = to(-np.abs(rng.randn(K, Dm, N)) - 0.5, torch.float32)
    B = to(rng.randn(G, L, N), dtype)
    C = to(rng.randn(G, L, N), dtype)
    D = to(rng.randn(K, Dm), torch.float32)
    bias = to(0.1 * rng.randn(K, Dm), torch.float32)
    return u, delta, A, B, C, D, bias


def bench_impl(fn, args, iters):
    """Seconds per call of ``fn(*args)``: one warm-up call, then CUDA
    events around ``iters`` calls."""
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", default="0")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--impl", default="cuda",
                   help="comma list: cuda (the folded entry's dispatch; the "
                   "JAX script's name 'pallas' means the same)")
    p.add_argument("--t-cap", type=int, default=None)
    p.add_argument("--vmem-budget-mb", type=int, default=None)
    p.add_argument("--calibrate", action="store_true",
                   help="run the no-scan elementwise floor kernel instead")
    return p


def _check_impl(spec):
    bad = [s for s in spec.split(",") if s not in ("cuda", "pallas")]
    if bad:
        raise ValueError(f"unknown --impl {bad} (expected cuda or pallas: "
                         "the folded entry's dispatch)")


def main(argv=None):
    """Run the bench; returns one record per stage: its times in ms and
    the calls each time covers (warm-up included)."""
    args = parser().parse_args(argv)
    _check_impl(args.impl)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench times the kernels on a CUDA device, "
                           "and torch sees none; it has no CPU mode")
    saved = (v1._T_CAP, v1._VMEM_BUDGET)
    try:
        if args.t_cap or args.vmem_budget_mb:
            if args.t_cap:
                v1._T_CAP = args.t_cap
            if args.vmem_budget_mb:
                v1._VMEM_BUDGET = args.vmem_budget_mb * 1024 * 1024
            print(f"# T_CAP={v1._T_CAP} VMEM_BUDGET={v1._VMEM_BUDGET >> 20}MB",
                  flush=True)
        stages = STAGES.keys() if args.stage == "all" else [args.stage]
        records = []
        for st in stages:
            cfg = STAGES[st]
            if args.calibrate:
                records.append(dict(stage=st, **calib_kernel_bench(
                    cfg, args.iters)))
                continue
            records.append(_bench_stage(
                st, cfg, make_inputs(**cfg, device="cuda"), args.iters))
        return records
    finally:
        v1._T_CAP, v1._VMEM_BUDGET = saved


def _bench_stage(st, cfg, ins, iters):
    u, delta, A, B, C, D, bias = ins

    def fwd_only(u, delta, A, B, C, D, bias):
        y = fwd.scan_folded_fwd(u, delta, A, B, C, D, bias)
        return y.float().sum()

    leaves = [t.detach().clone().requires_grad_(True) for t in (u, delta, B,
                                                               C)]

    def fwd_bwd(u, delta, A, B, C, D, bias):
        y = fwd.scan_folded_fwd(u, delta, A, B, C, D, bias)
        loss = y.float().sum()
        grads = torch.autograd.grad(loss, (u, delta, B, C))
        return loss + sum(g.float().sum() for g in grads)

    T = v1.v1_chunk(cfg["L"], cfg["Dm"], cfg["N"])
    tf = bench_impl(fwd_only, ins, iters)
    print(f"stage{st} G={cfg['G']} L={cfg['L']} Dm={cfg['Dm']}: "
          f"fwd {tf*1e3:.2f} ms", flush=True)
    tb = bench_impl(fwd_bwd, (leaves[0], leaves[1], A, leaves[2], leaves[3],
                              D, bias), iters)
    print(f"stage{st} G={cfg['G']} L={cfg['L']} Dm={cfg['Dm']}: "
          f"fwd+bwd {tb*1e3:.2f} ms   bwd~{(tb-tf)*1e3:.2f} ms", flush=True)
    return dict(stage=st, kernel="v2" if T is None else "v1",
                T=T, fwd_ms=tf * 1e3, fwd_bwd_ms=tb * 1e3,
                fwd_calls=iters + 1, fwd_bwd_calls=iters + 1)


def calib_kernel_bench(stage_cfg, iters):
    """Floor calibration: the scan forward's per-element work (exp + 4 muls
    + N-sum) at the stage's shape, no scan, over L padded to the tile
    chooser's T.  The gap fwd_scan - this = cost of the scan machinery."""
    G, L, Dm, N = (stage_cfg[k] for k in ("G", "L", "Dm", "N"))
    T, Dt = v1._choose_tiles(L, Dm, N)
    u, delta, A, B, C, D, bias = make_inputs(G, L, Dm, N, device="cuda")
    At = A.transpose(1, 2).contiguous()
    bf16 = bool(os.environ.get("CALIB_BF16"))

    def fn(u_, delta_, B_, C_):
        return calib_mod.scan_calib(u_, delta_, At, B_, C_, T,
                                    bf16_compute=bf16).float().sum()

    t = bench_impl(fn, (u, delta, B, C), iters)
    print(f"calib T={T} Dt={Dt}: {t*1e3:.2f} ms", flush=True)
    return dict(T=T, Dt=Dt, bf16_compute=bf16, calib_ms=t * 1e3,
                calls=iters + 1)


if __name__ == "__main__":
    main()
