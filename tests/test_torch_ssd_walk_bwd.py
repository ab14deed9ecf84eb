"""The plain twin of the SSD chunk walk's backward in the order of the CUDA
kernels' decomposition (``kernels/ssd_fused.py::walk_bwd_chunked_ref``:
every chunk's dSin at once, the state-passing recurrence, then the
chunk-local products) against the sequential twin ``walk_bwd_ref``, for
every cotangent, over both operand layouts: the single layout, and the
four-direction stack with its D skip and mirrored reverse-class heads.  At
one small shape per layout it also stands in for the sequential walk under
the JAX package's ``ssd_fused`` / ``ssd_fused_dirs`` VJPs, run in Pallas
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.kernels.ssd_fused_pallas as jsf
from medical_image_classification_tpu_torch.kernels import ssd_fused as sf
from medical_image_classification_tpu_torch.kernels import ssd_fused_dirs as sfd

torch.set_num_threads(2)
OUTS = ("dx", "dacum", "ddte", "dcdec", "ddtp", "dD", "dB", "dC")
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _rows(rng, B, nc, H, l):
    """dtp a softplus, acum its cumsum against a negative A, dte, cdec."""
    dtp = np.log1p(np.exp(rng.standard_normal((B, nc, H, l)) - 1.0))
    A = -(0.2 + 0.5 * rng.random(H))
    acum = np.cumsum(dtp * A[:, None], -1)
    dte = np.exp(acum[..., -1:] - acum)
    cdec = np.exp(acum[..., -1])
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (acum, dte, cdec, dtp))


def _walk_inputs(layout, B, nc, H, l, P, N, mm, seed):
    """The walk's operands in scan-position order, fp32 holding exact
    values of ``mm``: (x, Bf, Cf, acum, dte, cdec, dtp, Ssave, dy, Dsk).
    The dirs layout cuts x and the coupled B/C rows from a role-major
    stack (``ssd_fused_dirs._operands``: the reverse class mirrored, the
    flipped B/C halves of chunk nc - 1 - c) and adds a D skip."""
    rng = np.random.default_rng(seed)
    acum, dte, cdec, dtp = _rows(rng, B, nc, H, l)
    if layout == "dirs":
        nh, gn = H // 4, N // 4
        stack = torch.from_numpy((0.5 * rng.standard_normal(
            (B, nc, l, 2 * (nh * P + 2 * gn + nh)))).astype(np.float32))
        x, Bf, Cf = sfd._operands(stack.to(mm), nh * P, gn, H)
        Dsk = torch.from_numpy(rng.random(H).astype(np.float32))
    else:
        x, Bf, Cf = (torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32)).to(mm).float()
            for s, shape in ((1.0, (B, nc, H, l, P)), (0.3, (B, nc, l, N)),
                             (0.3, (B, nc, l, N))))
        Dsk = None
    _, Ssave = sf.walk_fwd_ref(x, Bf, Cf, acum, dte, cdec, dtp, mm, Dsk,
                               want_save=True)
    dy = torch.from_numpy(rng.standard_normal((B, nc, H, l, P)).astype(
        np.float32)).to(mm).float()
    return x, Bf, Cf, acum, dte, cdec, dtp, Ssave, dy, Dsk


# (layout, B, nc, H, l, P, N): one, two and three chunks; l 20 and 12 are
# not multiples of 16 (the kernels' ragged row tiles); N 128 is MedSSD's
# stage-1 coupled width at 240x240 and the dirs layout's 4 gn at gn 32
SHAPES = [("flat", 2, 1, 4, 16, 8, 128), ("flat", 2, 2, 3, 20, 8, 64),
          ("flat", 1, 3, 2, 12, 16, 128), ("dirs", 2, 1, 8, 16, 8, 128),
          ("dirs", 1, 2, 4, 20, 8, 128), ("dirs", 2, 3, 8, 12, 16, 64)]


@pytest.mark.parametrize("dt_name", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["-".join(map(str, s)) for s in SHAPES])
def test_chunked_twin_matches_sequential_walk(shape, dt_name):
    """Every cotangent of the decomposition against the sequential walk.
    fp32: the same products summed in other orders, within 1e-5 of each
    output's max.  bf16: operands rounded at the same places on both
    sides, so an output lands one bf16 step apart at worst where the two
    fp32 sums of a rounded intermediate (dSout, dscores) straddle a
    midpoint (rtol 3e-2, atol 5e-2, as the dirs tests hold bf16)."""
    layout, *dims = shape
    mm = DTYPES[dt_name]
    args = _walk_inputs(layout, *dims, mm, seed=sum(dims))
    *ops, Dsk = args
    want = sf.walk_bwd_ref(*ops, mm, Dsk)
    got = sf.walk_bwd_chunked_ref(*ops, mm, Dsk)
    for nm, g, w in zip(OUTS, got, want):
        if w is None:
            assert g is None and layout == "flat", nm
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, nm
        g, w = g.float().numpy(), w.float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        if dt_name == "fp32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                       err_msg=nm)
        else:
            np.testing.assert_allclose(g, w, rtol=3e-2, atol=5e-2,
                                       err_msg=nm)


def _close(got, want, rtol, atol_rel, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32).reshape(got.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_rel * max(1.0, float(np.abs(want).max())), err_msg=what)


# (rtol, atol as a share of max(1, max|JAX|)), as the layouts' own tests
# hold their plain backward against jax.vjp
JAX_CASES = [("fp32", jnp.float32, 1e-4, 1e-4),
             ("bf16", jnp.bfloat16, 3e-2, 3e-2)]


@pytest.mark.parametrize("name,jdt,rtol,atol", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_flat_backward_with_chunked_twin_matches_jax_vjp(
        monkeypatch, name, jdt, rtol, atol):
    """``ssd_fused_bwd_ref`` with the decomposition in place of the
    sequential walk: all seven cotangents against jax.vjp of ``ssd_fused``
    (its Pallas backward in interpret mode)."""
    monkeypatch.setattr(jsf, "_INTERPRET", True)
    monkeypatch.setattr(jsf, "_MIN_L", 8)
    monkeypatch.setattr(sf, "walk_bwd_ref", sf.walk_bwd_chunked_ref)
    rng = np.random.default_rng(7)
    B, nc, l, H, P, N = 2, 3, 12, 4, 8, 128
    C, Bm = (0.3 * rng.standard_normal((2, B, nc, l, N))).astype(np.float32)
    rows = [r.numpy() for r in _rows(rng, B, nc, H, l)]
    x, dy = rng.standard_normal((2, B, nc, l, H * P)).astype(np.float32)
    args = (C, Bm, *rows, x)
    mm = (0, 1, 6)
    ja = tuple(jnp.asarray(a, jdt if i in mm else jnp.float32)
               for i, a in enumerate(args))
    _, vjp = jax.vjp(jsf.ssd_fused, *ja)
    want = vjp(jnp.asarray(dy, jdt))
    tdt = DTYPES[name]
    ta = tuple(torch.from_numpy(a).to(tdt if i in mm else torch.float32)
               for i, a in enumerate(args))
    _, Ssave = sf.ssd_fused_fwd_ref(*ta, want_save=True)
    got = sf.ssd_fused_bwd_ref(*ta, Ssave, torch.from_numpy(dy).to(tdt))
    for nm, g, w in zip(("dC", "dB", "dacum", "ddte", "dcdec", "ddtp", "dx"),
                        got, want):
        _close(g, w, rtol, atol, nm)


@pytest.mark.parametrize("name,jdt,rtol,atol", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_dirs_backward_with_chunked_twin_matches_jax_vjp(
        monkeypatch, name, jdt, rtol, atol):
    """``ssd_fused_dirs_bwd_ref`` with the decomposition in place of the
    sequential walk: all six cotangents (the D skip's included) against
    jax.vjp of ``ssd_fused_dirs`` (its Pallas backward in interpret
    mode)."""
    monkeypatch.setattr(jsfd, "_INTERPRET", True)
    monkeypatch.setattr(jsfd, "_MIN_L", 8)
    monkeypatch.setattr(sfd, "walk_bwd_ref", sf.walk_bwd_chunked_ref)
    rng = np.random.default_rng(8)
    B, nc, l, nh, P, gn = 2, 2, 12, 4, 8, 32
    H4, d_ssm = 4 * nh, nh * P
    stack = (0.5 * rng.standard_normal(
        (B, nc, l, 2 * (d_ssm + 2 * gn + nh)))).astype(np.float32)
    rows = [r.numpy() for r in _rows(rng, B, nc, H4, l)]
    D = rng.random(H4).astype(np.float32)
    dy = rng.standard_normal((B, nc, l, H4 * P)).astype(np.float32)
    ja = (jnp.asarray(stack, jdt), *map(jnp.asarray, rows),
          jnp.asarray(D)[None, None])
    _, vjp = jax.vjp(lambda *z: jsfd.ssd_fused_dirs(*z, d_ssm, gn), *ja)
    want = vjp(jnp.asarray(dy, jdt))
    tdt = DTYPES[name]
    ta = (torch.from_numpy(stack).to(tdt),
          *map(torch.from_numpy, rows), torch.from_numpy(D))
    _, Ssave = sfd.ssd_fused_dirs_fwd_ref(*ta, d_ssm, gn, want_save=True)
    got = sfd.ssd_fused_dirs_bwd_ref(*ta, d_ssm, gn, Ssave,
                                     torch.from_numpy(dy).to(tdt))
    for nm, g, w in zip(("stackr", "acum", "dte", "cdec", "dtp", "Dsk"),
                        got, want):
        _close(g, w, rtol, atol, nm)


def _chip_smoke(monkeypatch):
    import os
    monkeypatch.syspath_prepend(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_walk_split_profiles_the_call(monkeypatch):
    """chip_smoke's per-pass split of the SSD walk profiles two calls of
    the function it is given and files each pass's mean time a launch
    under its label."""
    cs = _chip_smoke(monkeypatch)
    calls = []

    def fake_profile(fn):
        fn()
        return [dict(name=f"void ssd_walk::{k}<__nv_bfloat16, ssd_walk::"
                     f"DirsLayout<__nv_bfloat16> >(...)", count=len(calls),
                     device_us=1000.0 * (i + 1), cpu_us=0.0)
                for i, k in enumerate(cs.SSD_BWD_KERNELS)]

    monkeypatch.setattr(cs, "_profile", fake_profile)
    case = {"dtype": "bf16"}
    cs._walk_split(case, lambda: calls.append(1))
    assert len(calls) == 2
    assert case["split"] == {p: (i + 1) / 2
                             for i, p in enumerate(sf.BWD_PASSES)}


def test_chip_smoke_names_the_backward_passes(monkeypatch):
    """The profile patterns of the backward (the per-pass split and the
    medssd step's "ssd backward" share) name the kernels that
    csrc/ssd_walk_bwd.cuh defines, and the gram pass that it shares with
    the forward (csrc/ssd_walk_tiles.cuh), and the passes that
    ``bwd_pass_info`` reports, in launch order; the gram pass counts in
    the "ssd scores" share."""
    import re
    cs = _chip_smoke(monkeypatch)
    csrc = sf.__file__.rsplit("/", 2)[0] + "/csrc/"
    defined = {}
    for h in ("ssd_walk_bwd.cuh", "ssd_walk_tiles.cuh"):
        with open(csrc + h) as f:
            defined[h] = re.findall(r"__global__ void __launch_bounds__"
                                    r"\([^)]*\)\s*(\w+_kernel)\(", f.read())
    bwd = [f"bwd::{k}" for k in defined["ssd_walk_bwd.cuh"]]
    assert defined["ssd_walk_tiles.cuh"] == ["gram_kernel"]
    assert list(cs.SSD_BWD_KERNELS) == bwd[:1] + [cs.SSD_GRAM] + bwd[1:]
    assert [k.split("::")[-1][:-len("_kernel")]
            for k in cs.SSD_BWD_KERNELS] == list(sf.BWD_PASSES)
    assert cs.PATHS[("medssd", cs.SIZE)][1]["ssd backward"] == tuple(bwd)


_SASS = """
        code for sm_90a
                Function : _ZN8ssd_walk3bwd11gram_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvPKT_S7_PfNS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
                Function : _ZN8ssd_walk3bwd11prep_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvT0_PKfS7_S7_PKT_PS8_SB_NS_4DimsE
        /*0100*/                   FFMA R4, R8, R12, R4 ;
                Function : _ZN8ssd_walk3bwd11gram_kernelIfNS_10DirsLayoutIfEEEEvPKT_S5_PfNS_4DimsE
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("bare", [False, True])
def test_chip_smoke_counts_each_pass_tensor_core_instructions(monkeypatch,
                                                              bare):
    """chip_smoke reads each backward pass's HMMA count from the built
    library's SASS, per operand type, and fails where a bf16 pass that
    computes a product has none."""
    import shutil
    import subprocess
    import sys
    import types
    cs = _chip_smoke(monkeypatch)
    from medical_image_classification_tpu_torch.kernels import _build
    sass = _SASS.replace("HMMA", "IMAD") if bare else _SASS
    monkeypatch.setattr(shutil, "which", lambda name: sys.executable)
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        path=f"lib{name}.so"))
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: (
        subprocess.CompletedProcess(a, 0, stdout=sass, stderr="")))
    cs._ssd_mma.cache_clear()
    try:
        if bare:
            with pytest.raises(AssertionError, match="gram"):
                cs._ssd_mma("ssd_fused_dirs_bwd")
        else:
            assert cs._ssd_mma("ssd_fused_dirs_bwd") == {
                "fp32": {"gram": 0}, "bf16": {"gram": 2, "prep": 0}}
    finally:
        cs._ssd_mma.cache_clear()
