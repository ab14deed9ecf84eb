"""The STF gate kernels' decomposition in plain PyTorch, against the
sequential plain versions and the JAX package's Pallas gate (its custom VJP
``stf_zgate``, run in interpret mode as the JAX package's own tests run it
on the CPU): the forward's rows pass, the backward's rows pass (dpooledT)
and columns pass (dU and the per-batch dlz partials), at ragged P, both
kernel widths C, fp32 and bf16.  Also the twins' step against the CUDA
tiles, and chip_smoke's profile names, SASS counts and MUFU bound for the
gate's passes."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.stf_zgate_pallas as jszp
import medical_image_classification_tpu_torch.kernels.stf_zgate as tszp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "medical_image_classification_tpu_torch" / "csrc"

# (dtype, forward rtol/atol as a share of max|want|, backward rtol/atol).
# fp32: every side sums the same fp32 products in other orders.  bf16: the
# sides round the same fp32 sums at the same points (Z, dS, the outputs),
# so a value lands one bf16 step (2^-8 relative) apart where two sums
# straddle a rounding midpoint (the backward's dS steps carry on into
# dpooledT and dlz)
DTYPES = [("fp32", jnp.float32, torch.float32, 1e-5, (1e-4, 1e-5)),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2, (3e-2, 3e-2))]
# (BB, P, C): P a multiple of 8 but of neither kernel step (64 bf16, 32
# fp32), so both walks end on a ragged step, at both widths
SHAPES = [(2, 200, 128), (1, 392, 128), (1, 200, 256), (1, 392, 256)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jszp, "_INTERPRET", True)
    for mod in (jszp, tszp):
        monkeypatch.setattr(mod, "_MIN_PP", 8 * 8)


def _close(got, want, rtol, atol, what=""):
    if isinstance(want, torch.Tensor):
        want = want.float()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def _args(BB, P, C, seed=0):
    """pooledT N(0, 0.5^2), lz U[0, 1) (as at init: scores spread over
    the sigmoid's bend and its tails), U and dY N(0, 1), as float32 numpy
    arrays."""
    rng = np.random.default_rng(seed)
    pT = (0.5 * rng.standard_normal((BB, P, C))).astype(np.float32)
    lz = rng.random((C, P)).astype(np.float32)
    U, dY = rng.standard_normal((2, BB, P, C)).astype(np.float32)
    return pT, lz, U, dY


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("BB,P,C", SHAPES,
                         ids=[f"P{s[1]}-C{s[2]}" for s in SHAPES])
def test_passes_twins_match_sequential_and_jax(case, BB, P, C):
    """The forward twin's Y against the sequential plain forward and the
    JAX forward; the backward twin's (dpooledT, dlz, dU) against the
    sequential plain backward and jax.vjp of the JAX gate, the cotangent
    given in the operand dtype.  Both sides' gates take the shape."""
    dt_name, jdt, tdt, ftol, (brtol, batol) = case
    assert tszp.stf_zgate_supported(P, C)
    assert jszp.stf_zgate_supported(P, C, jnp.dtype(jdt).itemsize)
    arrays = _args(BB, P, C, seed=P + C)
    pT, lz, U, dY = (torch.from_numpy(a).to(tdt) for a in arrays)
    jpT, jlz, jU, jdY = (jnp.asarray(a, jdt) for a in arrays)

    Y = tszp.stf_zgate_fwd_passes_ref(pT, lz, U)
    assert Y.dtype == tdt and Y.shape == (BB, P, C)
    _close(Y, tszp.stf_zgate_fwd_ref(pT, lz, U), ftol, ftol,
           "Y vs sequential")
    Y_jax, vjp = jax.vjp(jszp.stf_zgate, jpT, jlz, jU)
    _close(Y, Y_jax, ftol, ftol, "Y vs JAX")

    got = tszp.stf_zgate_bwd_passes_ref(pT, lz, U, dY)
    want_seq = tszp.stf_zgate_bwd_ref(pT, lz, U, dY)
    want_jax = vjp(jdY)
    for nm, g, ws, wj, t in zip(("dpooledT", "dlz", "dU"), got, want_seq,
                                want_jax, (pT, lz, U)):
        assert g.dtype == t.dtype and g.shape == t.shape, nm
        _close(g, ws, brtol, batol, f"{nm} vs sequential")
        _close(g, wj, brtol, batol, f"{nm} vs JAX")


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=str)
def test_twins_gate_the_far_tails(tdt):
    """Scores of +-90 (beyond where 2^x overflows or flushes in the
    kernels' bf16 sigmoid) gate to 1 and to below 1e-38 in the twins as in
    the sequential plain versions: Y is U's column sums or ~0, and every
    cotangent is finite (dS = dZ Z (1 - Z) is 0 at both ends)."""
    BB, P, C = 1, 40, 128
    pT = torch.zeros(BB, P, C, dtype=tdt)
    pT[0, :20, 0], pT[0, 20:, 0] = 90.0, -90.0
    lz = torch.zeros(C, P, dtype=tdt)
    lz[0] = 1.0
    U = torch.ones(BB, P, C, dtype=tdt)
    for Y in (tszp.stf_zgate_fwd_passes_ref(pT, lz, U),
              tszp.stf_zgate_fwd_ref(pT, lz, U)):
        assert torch.equal(Y[0, :20].float(), torch.full((20, C), float(P)))
        assert float(Y[0, 20:].float().abs().max()) < 1e-38
    for g in tszp.stf_zgate_bwd_passes_ref(pT, lz, U, U):
        assert torch.isfinite(g.float()).all()


def test_twins_step_is_the_kernels():
    """The twins walk in the kernels' step: STEP is Cfg::kStep of
    csrc/stl_mixer_tiles.cuh, whose tiles both gate kernels use through
    csrc/stf_zgate_tiles.cuh."""
    src = (CSRC / "stl_mixer_tiles.cuh").read_text()
    step = re.search(r"kStep = kBf16 \? (\d+) : (\d+);", src)
    assert step
    assert tszp.STEP == {torch.bfloat16: int(step.group(1)),
                         torch.float32: int(step.group(2))}
    assert '#include "stl_mixer_tiles.cuh"' in (
        CSRC / "stf_zgate_tiles.cuh").read_text()
    for name in ("stf_zgate_fwd.cu", "stf_zgate_bwd.cu"):
        text = (CSRC / name).read_text()
        assert '#include "stf_zgate_tiles.cuh"' in text, name
        assert "st_tiles.cuh" not in text.replace("stf_zgate_tiles", ""), name


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


_SASS = """
        code for sm_90a
                Function : _ZN9stf_zgate21zgate_bwd_rows_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PS2_i
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
                Function : _ZN9stf_zgate21zgate_bwd_cols_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_S4_PS2_Pfi
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN9stf_zgate21zgate_bwd_cols_kernelIfLi128EEEvPKT_S2_S2_S2_PS0_Pfi
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("bare", [False, True])
def test_chip_smoke_counts_the_gate_passes_hmma(monkeypatch, bare):
    """chip_smoke reads each gate pass's HMMA count per operand type and C
    from the built library's SASS, and fails where a bf16 pass has none."""
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
    cs._stl_mma.cache_clear()
    try:
        if bare:
            with pytest.raises(AssertionError, match="rows C128"):
                cs._stl_mma("stf_zgate_bwd")
        else:
            assert cs._stl_mma("stf_zgate_bwd") == {
                "fp32": {"cols C128": 0},
                "bf16": {"rows C128": 2, "cols C256": 1}}
    finally:
        cs._stl_mma.cache_clear()


@pytest.mark.parametrize("dt_name,dtype", [("bf16", torch.bfloat16),
                                           ("fp32", torch.float32)])
def test_chip_smoke_gate_bound_names_the_sigmoids(monkeypatch, dt_name,
                                                  dtype):
    """At st_ssd's stage 0 (BB 32, P 3136, C 128) the gate's BB P^2 bf16
    sigmoids take 0.1505 ms at the MUFU rate (two ops each), under the
    forward's 0.1629 ms product bound, which stays the bound; in fp32 the
    products bound it.  Shapes only: meta tensors."""
    cs = _chip_smoke(monkeypatch)
    BB, P, C = 32, 3136, 128
    args = (torch.empty(BB, P, C, dtype=dtype, device="meta"),
            torch.empty(C, P, dtype=dtype, device="meta"),
            torch.empty(BB, P, C, dtype=dtype, device="meta"))
    mufu = cs._stf_mufu_ms(args)
    assert mufu == pytest.approx(BB * P * P * 2 / cs.MUFU_PER_S * 1e3)
    assert mufu == pytest.approx(0.1505, abs=1e-4)
    fwd, bwd = cs._stf_bound(args, dt_name, False), \
        cs._stf_bound(args, dt_name, True)
    peak = cs.PEAK_OPS[dt_name]
    assert fwd == (pytest.approx(4 * BB * P * P * C / peak * 1e3),
                   "operations")
    assert bwd == (pytest.approx(10 * BB * P * P * C / peak * 1e3),
                   "operations")
    assert fwd[0] > mufu
    # the larger of the two where the sigmoids are: at C 16 the MUFU time
    # would bound the bf16 forward
    thin = (torch.empty(BB, P, 16, dtype=dtype, device="meta"),) + args[1:]
    t = cs._stf_bound(thin, dt_name, False)
    if dt_name == "bf16":
        assert t == (pytest.approx(mufu), "operations")
    else:
        assert t[0] > mufu


def test_chip_smoke_split_profiles_again_what_a_window_missed(monkeypatch):
    """The gate forward launches one kernel a call, and a profile window
    that misses its first launches records nothing of it: _walk_split
    profiles again over twice the calls until the pass shows (here on the
    third window, 8 calls), and names a pass that never shows instead of
    printing an empty split."""
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs.time, "sleep", lambda s: None)
    windows, calls = [], []

    def fake_profile(fn):
        calls.clear()
        fn()
        windows.append(len(calls))
        name = "void stf_zgate::zgate_fwd_rows_kernel<__nv_bfloat16, 128>"
        return ([dict(name=name, count=2, device_us=1600.0, cpu_us=0.0)]
                if len(windows) == 3 else [])

    monkeypatch.setattr(cs, "_profile", fake_profile)
    case = {"dtype": "bf16"}
    cs._walk_split(case, lambda: calls.append(1), cs.STF_FWD_SPLIT)
    assert windows == [2, 4, 8]
    assert case["split"] == {"rows": 0.8} and "unrecorded" not in case
    assert cs._split_text(case) == " split rows=0.800ms"

    windows.clear()
    monkeypatch.setattr(cs, "_profile", lambda fn: windows.append(0) or [])
    case = {"dtype": "bf16"}
    cs._walk_split(case, lambda: None, cs.STF_BWD_SPLIT)
    assert len(windows) == 3 and case["split"] == {}
    assert cs._split_text(case) == (" split rows=not recorded "
                                    "cols=not recorded")
