"""How far the fusion U-Nets' fp32 gradients lie from float64, per path.

    python -m medical_image_classification_tpu_torch.scripts.grad_conditioning \\
        [--models vfefm_2c1 vfefm_2b2 fusionmamba] [--gate-paths] [--out FILE]

Run from the repo's root (it uses ``chip_smoke.py``'s helpers: the
seeded vfefm_2b2 / vfefm_2c1 / fusionmamba weights at full width, the
256x256 pair batch of 2, ``_path_grads``).  For each model and each loss
of the smoke's gradient gate (the fusion loss, mean(out); FusionMamba's
FM_GRAD_LOSSES on its dark one-channel pairs) it takes every parameter's
gradient in float64 through the plain einsums and in fp32 by four paths:
the kernels, their plain twins, the kernels with Y_diag's plain twin in
place of its kernel, the plain twins with Y_diag's kernel, and every SSD
through the einsums (float64's algorithm in fp32); then again
with the train-mode BatchNorm variance in two passes (mean of squared
deviations) in place of E[x^2] - E[x]^2, in every path.  For each fp32
path against float64 it prints the leaves beyond PARAM_GRAD_TOL (above its
abs floor), counted by stage, and the worst and median leaf; for the
kernels the leaves that ``_check_grad_tree_exact`` would refuse, and the
leaves where the kernels and the plain twins miss PARAM_GRAD_TOL of each
other; and for each abs floor of FLOOR_SWEEP the kernel leaves the
conditioned gate would check and refuse, beside the float64 gradient's
norms.  ``--gate-paths`` takes only the gate's own paths (the kernels,
the plain twins, float64) and the one-pass variance; FusionMamba (no SSD,
no BatchNorm) always does.  Before
that, the Y_diag kernel and its plain twin in fp32 against float64 at the
U-Nets' shapes (BC 2, l 256, N 512, P 64, H 32 and 64), forward and every
cotangent.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import math


def _ydiag_vs_float64(device="cuda", impls=("cuda", "torch")):
    """Rel-norm errors of y, dC, dB, dacum, ddtx against float64."""
    import torch
    from medical_image_classification_tpu_torch.kernels import ssd_ydiag

    def exact(C, B, a, x):
        l = C.shape[1]
        seg = a[..., :, None] - a[..., None, :]
        causal = torch.ones(l, l, dtype=torch.bool, device=C.device).tril()
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        return ((C @ B.transpose(1, 2))[:, None] * decay) @ x

    rows = []
    for H in (32, 64):
        g = torch.Generator(device=device).manual_seed(H)
        BC, l, N, P = 2, 256, 512, 64
        rnd = lambda *s: torch.randn(*s, device=device, generator=g)
        ins = (0.3 * rnd(BC, l, N), 0.3 * rnd(BC, l, N), torch.cumsum(
            -0.05 * torch.rand(BC, H, l, device=device, generator=g), -1),
               rnd(BC, H, l, P))
        dy = rnd(BC, H, l, P)
        res = {}
        for impl in impls + ("float64",):
            dt = torch.float64 if impl == "float64" else torch.float32
            xs = [t.to(dt).clone().requires_grad_(True) for t in ins]
            y = exact(*xs) if impl == "float64" else ssd_ydiag.ydiag_fused(
                *xs, impl=impl)
            y.backward(dy.to(dt))
            res[impl] = [y.detach().double()] + [t.grad.double() for t in xs]
        rows.append(dict(H=H, **{impl: [
            float((a - b).norm() / b.norm())
            for a, b in zip(res[impl], res["float64"])]
            for impl in impls}))
    return rows


def _two_pass_batch_norm(orig):
    import torch

    def batch_norm(mod, x, training, update_stats=True):
        if not training:
            return orig(mod, x, training, update_stats)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        centred = x - x.mean(dims).view(shape)
        var = centred.square().mean(dims)
        mul = torch.rsqrt(var + mod.eps) * mod.weight
        return centred * mul.view(shape) + mod.bias.view(shape)
    return batch_norm


def _stage(name):
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("layers", "layers_up") \
        else parts[0]


FLOOR_SWEEP = (2e-4, 1e-5, 1e-6, 1e-7, 0.0)


def _refused(cs, errs, got, exact, floor):
    """The kernel leaves over the abs ``floor`` and those of them the
    conditioned gate refuses (``_check_grad_tree_exact``'s rule)."""
    rtol, min_cos, _ = cs.PARAM_GRAD_TOL
    checked, refused = 0, []
    for n, (r, c) in errs["kernels"].items():
        if float((got[n] - exact[n]).norm()) <= floor:
            continue
        checked += 1
        cap = rtol + cs.COND_RATIO * errs["plain"][n][0]
        if r > cap or c < min(min_cos, math.sqrt(max(0.0, 1 - cap * cap))):
            refused.append((n, r, c, errs["plain"][n]))
    return checked, refused


def _report(cs, grads, what):
    """The per-path numbers of one loss against float64."""
    rtol, min_cos, floor = cs.PARAM_GRAD_TOL
    exact = grads["float64"][what][1]
    errs, out = {}, {}
    for path, res in grads.items():
        if path == "float64":
            continue
        g = res[what][1]
        errs[path] = cs._leaf_errs(path, g, exact, -1.0)
        big = {n: v for n, v in errs[path].items()
               if float((g[n] - exact[n]).norm()) > floor}
        over = [n for n, (r, c) in big.items() if r > rtol or c < min_cos]
        rels = sorted(r for r, _ in big.values())
        out[path] = dict(
            loss=res[what][0], over=len(over),
            by_stage=dict(collections.Counter(map(_stage, over))),
            worst=sorted(((round(big[n][0], 5), n) for n in over),
                         reverse=True)[:4],
            median_rel=rels[len(rels) // 2] if rels else 0.0)
    got = grads["kernels"][what][1]
    _, refused = _refused(cs, errs, got, exact, floor)
    norms = sorted(float(v.norm()) for v in exact.values())
    live = {n: v for n, v in errs["kernels"].items()
            if float(exact[n].norm()) > 0}
    rels = sorted(r for r, _ in live.values())
    out["float64_norms"] = dict(
        tree=math.sqrt(sum(v * v for v in norms)), largest_leaf=norms[-1],
        smallest_nonzero_leaf=min((v for v in norms if v > 0), default=0.0),
        zero_leaves=sum(1 for v in norms if v == 0))
    out["kernels_every_nonzero_leaf"] = dict(
        leaves=len(rels), worst_rel=rels[-1] if rels else 0.0,
        median_rel=rels[len(rels) // 2] if rels else 0.0,
        worst_cos=min((c for _, c in live.values()), default=1.0))
    out["floor_sweep"] = {}
    for f in FLOOR_SWEEP:
        n_checked, bad = _refused(cs, errs, got, exact, f)
        out["floor_sweep"][f] = dict(checked=n_checked, refused=len(bad),
                                     worst_refused=sorted(
                                         bad, key=lambda t: -t[1])[:3])
    vs_plain = cs._leaf_errs("kernels vs plain", grads["kernels"][what][1],
                             grads["plain"][what][1], floor)
    out["kernels_vs_plain_over"] = sum(
        1 for r, c in vs_plain.values() if r > rtol or c < min_cos)
    out["float64_loss"] = grads["float64"][what][0]
    out["gate_refuses"] = refused
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the numbers as JSON")
    p.add_argument("--models", nargs="+", default=["vfefm_2c1", "vfefm_2b2"],
                   choices=["vfefm_2c1", "vfefm_2b2", "fusionmamba"])
    p.add_argument("--gate-paths", action="store_true",
                   help="only the gate's paths and the one-pass variance")
    args = p.parse_args(argv)
    import chip_smoke as cs
    import torch
    from medical_image_classification_tpu_torch.kernels import ssd
    from medical_image_classification_tpu_torch.models import common
    from medical_image_classification_tpu_torch.ops import ss2d
    card = cs.phase_device_and_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = dict(card=card, ydiag=_ydiag_vs_float64())
    for row in result["ydiag"]:
        print(f"Y_diag fp32 H {row['H']}: rel-norm from float64 of y, dC, "
              f"dB, dacum, ddtx: kernel {row['cuda']}, plain {row['torch']}",
              flush=True)
    ydiag = ssd.ydiag_fused
    swap = lambda impl: [(ssd, "ydiag_fused", lambda *a, **k: ydiag(
        *a, **dict(k, impl=impl)))]
    # the einsums everywhere, as float64 takes them
    einsum = [(ss2d, "ssd_dirs_chunk", lambda *a, **k: None),
              (ssd, "ssd_fused_supported", lambda *a, **k: False),
              (ssd, "ydiag_supported", lambda *a, **k: False)]
    paths = {"float64": ("float64", []), "kernels": ("cuda", []),
             "plain": ("torch", []),
             "kernels, Y_diag plain": ("cuda", swap("torch")),
             "plain, Y_diag kernel": ("torch", swap("cuda")),
             "fp32 einsums": ("torch", einsum)}
    gate = ("float64", "kernels", "plain")
    for name in args.models:
        fm = name == "fusionmamba"
        batch = ([cs.FM_DARK * t for t in cs._fusion_batch(
            cs.FUSION_BATCH, 3, 1)] if fm
            else cs._fusion_batch(cs.FUSION_BATCH, 3))
        losses = cs.FM_GRAD_LOSSES if fm else cs.FUSION_GRAD_LOSSES
        sd = cs._fusion_model(name, None, "torch").state_dict()
        variants = ("one-pass variance",) if fm or args.gate_paths else (
            "one-pass variance", "two-pass variance")
        for variant in variants:
            grads = {}
            for path, (impl, patches) in paths.items():
                if (fm or args.gate_paths) and path not in gate:
                    continue
                if variant == "two-pass variance":
                    patches = patches + [(common, "batch_norm",
                                          _two_pass_batch_norm(
                                              common.batch_norm))]
                saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
                for m, a, v in patches:
                    setattr(m, a, v)
                try:
                    grads[path] = cs._path_grads(
                        name, sd, batch, losses, impl)
                finally:
                    for m, a, v in saved:
                        setattr(m, a, v)
            for what in losses:
                rep = _report(cs, grads, what)
                result[f"{name} {variant} {what}"] = rep
                print(f"{name}, {variant}, {what}: " + json.dumps(
                    rep, default=str), flush=True)
            del grads
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


if __name__ == "__main__":
    main()
