"""The Y_diag kernels' decomposition in plain PyTorch
(``ydiag_fwd_passes_ref``, ``ydiag_bwd_passes_ref``) against the sequential
plain versions and the JAX package's Pallas Y_diag (its custom VJP
``ydiag_fused``, run in interpret mode as the JAX package's own tests run it
on the CPU): values and all four cotangents at ragged l (not a multiple of
the 64-row tile), N 64 and 512, one head and several, fp32 and bf16.  Also
the twins' tiles against the CUDA sources, and chip_smoke's profile names,
split and SASS counts for Y_diag's passes."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "medical_image_classification_tpu_torch" / "csrc"

# (dtype, forward rtol/atol as a share of max|want|, backward rtol/atol).
# fp32: every side sums the same fp32 products in other orders.  bf16: the
# sides round the same fp32 sums at the same points (M, the head-summed
# dscores, the outputs), so a value lands one bf16 step (2^-8 relative)
# apart where two sums straddle a rounding midpoint; a dscores step carries
# on into dC and dB
DTYPES = [("fp32", jnp.float32, torch.float32, 1e-5, (1e-4, 1e-5)),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2, (3e-2, 3e-2))]
# (BC, l, H, N, P): l 40 and 72 ragged against the 64-row tiles (one tile;
# two, the second of 8 rows), 136 three tiles; one head and several; N 64
# and 512; P 8 and 16 (a fraction of a 64-wide P tile)
SHAPES = [(2, 40, 1, 64, 16), (1, 72, 4, 64, 8), (1, 72, 3, 512, 16),
          (1, 136, 2, 64, 8)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jyd, "_INTERPRET", True)
    for mod in (jyd, tyd):
        monkeypatch.setattr(mod, "_MIN_L", 8)


def _close(got, want, rtol, atol, what=""):
    if isinstance(want, torch.Tensor):
        want = want.float()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def _args(BC, l, H, N, P, seed):
    """Cc, Bc N(0, 0.5^2); acum the cumsum of softplus steps against
    A = -U(1, 4), as ssd_chunked builds it; dtx and dy N(0, 1): float32
    numpy arrays."""
    rng = np.random.default_rng(seed)
    C, B = (0.5 * rng.standard_normal((2, BC, l, N))).astype(np.float32)
    dtp = np.log1p(np.exp(0.5 * rng.standard_normal((BC, H, l)) - 3.0))
    A = -(1.0 + 3.0 * rng.random((H, 1)))
    acum = np.cumsum(dtp * A, -1).astype(np.float32)
    dtx, dy = rng.standard_normal((2, BC, H, l, P)).astype(np.float32)
    return C, B, acum, dtx, dy


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("BC,l,H,N,P", SHAPES,
                         ids=[f"l{s[1]}-H{s[2]}-N{s[3]}" for s in SHAPES])
def test_passes_twins_match_sequential_and_jax(case, BC, l, H, N, P):
    """The forward twin's y against the sequential plain forward and the
    JAX forward; the backward twin's (dCc, dBc, dacum, ddtx) against the
    sequential plain backward and jax.vjp of the JAX ydiag_fused, the
    cotangent given in the operand dtype.  Both sides' gates take the
    shape."""
    dt_name, jdt, tdt, ftol, (brtol, batol) = case
    assert tyd.ydiag_supported(l, N, P, 1)
    assert jyd.ydiag_supported(l, N, P, 1, H, jnp.dtype(jdt).itemsize)
    C, B, acum, dtx, dy = _args(BC, l, H, N, P, seed=l + N + H)
    tC, tB, tx, tdy = (torch.from_numpy(a).to(tdt) for a in (C, B, dtx, dy))
    ta = torch.from_numpy(acum)
    jC, jB, jx, jdy = (jnp.asarray(a, jdt) for a in (C, B, dtx, dy))

    y = tyd.ydiag_fwd_passes_ref(tC, tB, ta, tx)
    assert y.dtype == tdt and y.shape == (BC, H, l, P)
    _close(y, tyd.ydiag_fused_ref(tC, tB, ta, tx), ftol, ftol,
           "y vs sequential")
    y_jax, vjp = jax.vjp(jyd.ydiag_fused, jC, jB, jnp.asarray(acum), jx)
    _close(y, y_jax, ftol, ftol, "y vs JAX")

    got = tyd.ydiag_bwd_passes_ref(tC, tB, ta, tx, tdy)
    want_seq = tyd.ydiag_fused_bwd_ref(tC, tB, ta, tx, tdy)
    want_jax = vjp(jdy)
    for nm, g, ws, wj, t in zip(("dCc", "dBc", "dacum", "ddtx"), got,
                                want_seq, want_jax, (tC, tB, ta, tx)):
        assert g.dtype == t.dtype and g.shape == t.shape, nm
        _close(g, ws, brtol, batol, f"{nm} vs sequential")
        _close(g, wj, brtol, batol, f"{nm} vs JAX")


def test_twins_mask_the_decay_past_the_diagonal():
    """A steep cumsum (a drops by 60 a step, so exp(a_j - a_i) for j > i
    would overflow fp32): the twins take exp of the exact difference only
    inside the causal triangle, so every output and cotangent is finite and
    y[i] sees only j <= i (here: one nonzero dtx row, at j = 50)."""
    BC, l, H, N, P = 1, 72, 2, 64, 8
    C, B, _, _, dy = _args(BC, l, H, N, P, seed=5)
    acum = -60.0 * torch.arange(1, l + 1, dtype=torch.float32).repeat(
        BC, H, 1)
    dtx = torch.zeros(BC, H, l, P)
    dtx[:, :, 50] = 1.0
    tC, tB, tdy = (torch.from_numpy(a) for a in (C, B, dy))
    y = tyd.ydiag_fwd_passes_ref(tC, tB, acum, dtx)
    assert torch.isfinite(y).all()
    assert torch.equal(y[:, :, :50], torch.zeros(BC, H, 50, P))
    assert float(y[:, :, 50].abs().max()) > 0.0
    for g in tyd.ydiag_bwd_passes_ref(tC, tB, acum, dtx, tdy):
        assert torch.isfinite(g).all()


def _header(name):
    return (CSRC / name).read_text()


def test_twins_tiles_are_the_kernels():
    """The twins walk the kernels' tiles: TILE is kT of the strip passes
    (csrc/ssd_ydiag_strip.cuh), of the SSD walks' passes that the bf16
    backward runs (csrc/ssd_walk_tiles.cuh) and of the fp32 backward's
    tiles (csrc/st_tiles.cuh), MAX_L the strip's kMaxL; the backward
    instantiates the walk's passes over YDiagLayout; only the fp32
    backward includes the first port's tiles, now fp32 only."""
    strip = _header("ssd_ydiag_strip.cuh")
    for name in ("ssd_ydiag_strip.cuh", "ssd_walk_tiles.cuh", "st_tiles.cuh"):
        assert int(re.search(r"constexpr int kT = (\d+);",
                             _header(name)).group(1)) == tyd.TILE, name
    assert int(re.search(r"constexpr int kMaxL = (\d+);", strip).group(1)) \
        == tyd.MAX_L
    fwd, bwd = _header("ssd_ydiag_fwd.cu"), _header("ssd_ydiag_bwd.cu")
    assert '#include "ssd_ydiag_strip.cuh"' in fwd
    for inc in ('#include "ssd_walk_bwd.cuh"', '#include "ssd_ydiag_strip.cuh"',
                '#include "st_tiles.cuh"'):
        assert inc in bwd
    assert "YDiagLayout" in bwd
    assert [p.name for p in sorted(CSRC.iterdir())
            if '#include "st_tiles.cuh"' in p.read_text()] == [
        "ssd_ydiag_bwd.cu"]
    assert "bfloat16" not in _header("st_tiles.cuh")


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def _globals(name):
    """The __global__ kernels a csrc/ file defines."""
    return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                      r"(\w+_kernel)\(", _header(name))


def test_chip_smoke_names_the_ydiag_passes(monkeypatch):
    """2e/2h's splits and the model paths' Y_diag shares name the kernels
    that Y_diag's passes are: the strip passes of csrc/ssd_ydiag_strip.cuh
    and the walk backward's intra and flush passes, told apart from the
    walks' own in a model's profile by YDiagLayout; the splits' labels are
    the passes ``fwd_pass_info`` and ``bwd_pass_info`` report."""
    cs = _chip_smoke(monkeypatch)
    assert _globals("ssd_ydiag_strip.cuh") == ["rows_kernel", "cols_kernel"]
    walk_bwd = _globals("ssd_walk_bwd.cuh")
    assert list(cs.YDIAG_FWD_SPLIT) == list(tyd.FWD_PASSES)
    assert list(cs.YDIAG_BWD_SPLIT) == list(tyd.BWD_PASSES[torch.bfloat16])
    for p in list(cs.YDIAG_FWD_SPLIT.values()) + list(
            cs.YDIAG_BWD_SPLIT.values()):
        ns, base = p.split("::")
        assert base in (walk_bwd if ns == "bwd" else
                        _globals("ssd_ydiag_strip.cuh")), p
    assert re.search(r"struct YDiagLayout\b", _header("ssd_walk_common.cuh"))
    for key in (("st_ssd", cs.SIZE), ("medssd", cs.MEDSSD_240)):
        shares = cs.PATHS[key][1]
        assert shares["ssd ydiag"] == ("ssd_ydiag::rows_kernel",)
        assert shares["ssd ydiag backward"] == ("ssd_ydiag::cols_kernel",
                                                "YDiagLayout")
    # at 240x240 the walks' own passes fall in their layouts' shares only
    shares = cs.PATHS[("medssd", cs.MEDSSD_240)][1]
    walk = "void ssd_walk::bwd::intra_kernel<__nv_bfloat16, ssd_walk::{}<" \
           "__nv_bfloat16> >(...)"
    hits = {lay: [k for k, pats in shares.items()
                  if any(p in walk.format(lay) for p in pats)]
            for lay in ("FlatLayout", "DirsLayout", "YDiagLayout")}
    assert hits == {"FlatLayout": ["ssd fused"], "DirsLayout": ["ssd dirs"],
                    "YDiagLayout": ["ssd ydiag backward"]}


def test_chip_smoke_splits_a_ydiag_backward_call(monkeypatch):
    """2h's split profiles two calls and files each backward pass's mean
    device time a launch under its label."""
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs.time, "sleep", lambda s: None)
    names = ["void ssd_walk::bwd::intra_kernel<__nv_bfloat16, ssd_walk::"
             "YDiagLayout<__nv_bfloat16> >(...)",
             "void ssd_ydiag::cols_kernel<__nv_bfloat16>(...)",
             "void ssd_walk::bwd::flush_kernel<__nv_bfloat16, ssd_walk::"
             "YDiagLayout<__nv_bfloat16> >(...)"]
    calls = []

    def fake_profile(fn):
        fn()
        return [dict(name=n, count=2, device_us=1000.0 * (i + 1),
                     cpu_us=0.0) for i, n in enumerate(names)]

    monkeypatch.setattr(cs, "_profile", fake_profile)
    case = {"dtype": "bf16"}
    cs._walk_split(case, lambda: calls.append(1), cs.YDIAG_BWD_SPLIT)
    assert len(calls) == 2
    assert case["split"] == {"intra": 0.5, "cols": 1.0, "flush": 1.5}
    assert cs._split_text(case) == \
        " split intra=0.500ms cols=1.000ms flush=1.500ms"


_SASS = """
        code for sm_90a
                Function : _ZN8ssd_walk3bwd12intra_kernelI13__nv_bfloat16NS_11YDiagLayoutIS2_EEEEvT0_PKfPKT_SA_S7_PS8_PfSC_NS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
                Function : _ZN9ssd_ydiag11cols_kernelI13__nv_bfloat16EEvPKT_S4_PKfS4_PS2_NS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN8ssd_walk3bwd12flush_kernelI13__nv_bfloat16NS_11YDiagLayoutIS2_EEEEvT0_PKT_S8_S8_S8_S8_S8_NS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN12_GLOBAL__N_13f3211grad_kernelEPKfS2_S2_S2_S2_PfS3_S3_S3_NS0_4DimsE
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("bare", [False, True])
def test_chip_smoke_counts_the_ydiag_passes_hmma(monkeypatch, bare):
    """chip_smoke reads each Y_diag pass's HMMA count per operand type from
    the built library's SASS (the fp32 backward's passes of the first port
    too), and fails where a bf16 pass has none."""
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
            with pytest.raises(AssertionError, match="intra"):
                cs._ssd_mma("ssd_ydiag_bwd")
        else:
            assert cs._ssd_mma("ssd_ydiag_bwd") == {
                "fp32": {"grad": 0},
                "bf16": {"intra": 2, "cols": 1, "flush": 1}}
    finally:
        cs._ssd_mma.cache_clear()
