"""The STL mixer kernels' decomposition in plain PyTorch, against the
sequential plain versions and the JAX package's Pallas mixer (its custom
VJP ``_mixer``, run in interpret mode as the JAX package's own tests run it
on the CPU): the forward's rows pass (each row's log-sum-exp from per-lane
running statistics) and columns pass, and the backward's two row walks
(rowdot and dV, then dw) and columns pass (du1), at ragged P, both kernel
widths C, fp32 and bf16.  Also the saved statistics (the plain forward's
lse is the softmax's; ``STLMixer`` hands the forward's lse to the
backward), the wrappers' lse checks, the twins' step against the CUDA
tiles, and chip_smoke's profile names and SASS counts for the mixer."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.stl_mixer_pallas as jsmp
import medical_image_classification_tpu_torch.kernels.stl_mixer as tsmp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "medical_image_classification_tpu_torch" / "csrc"

# (dtype, forward rtol/atol as a share of max|want|, backward rtol/atol).
# fp32: every side sums the same fp32 products in other orders.  bf16: the
# sides round the same fp32 sums at the same points (E, dS, the outputs),
# so a value lands one bf16 step (2^-8 relative) apart where two sums
# straddle a rounding midpoint (the backward's dS steps carry on into dw
# and du1)
DTYPES = [("fp32", jnp.float32, torch.float32, 1e-5, (1e-4, 1e-5)),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2, (3e-2, 3e-2))]
# (BB, L, P, C): ragged P against both kernel steps (64 bf16, 32 fp32), a
# ragged last step of L, both widths
SHAPES = [(2, 72, 200, 128), (1, 64, 384, 128), (1, 40, 200, 256),
          (1, 48, 384, 256)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsmp, "_INTERPRET", True)


def _close(got, want, rtol, atol, what=""):
    if isinstance(want, torch.Tensor):
        want = want.float()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def _args(BB, L, P, C, seed=0):
    """w, V N(0, 0.5^2), u1 U[0, 0.3) (positive, as at init: rows with a
    dominant column), dU N(0, 1), as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    w, V = (0.5 * rng.standard_normal((2, BB, L, C))).astype(np.float32)
    u1 = (0.3 * rng.random((C, P))).astype(np.float32)
    dU = rng.standard_normal((BB, P, C)).astype(np.float32)
    return w, u1, V, dU


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("BB,L,P,C", SHAPES,
                         ids=[f"P{s[2]}-C{s[3]}" for s in SHAPES])
def test_passes_twins_match_sequential_and_jax(case, BB, L, P, C):
    """The forward twin's U and lse against the sequential plain forward,
    and U against the JAX forward; the backward twin's (dw, du1, dV) from
    that lse against the sequential plain backward and jax.vjp of the JAX
    mixer, the cotangent given in the operand dtype."""
    dt_name, jdt, tdt, ftol, (brtol, batol) = case
    arrays = _args(BB, L, P, C, seed=P + C)
    w, u1, V, dU = (torch.from_numpy(a).to(tdt) for a in arrays)
    jw, ju1, jV, jdU = (jnp.asarray(a, jdt) for a in arrays)

    U, lse = tsmp.stl_mixer_fwd_passes_ref(w, u1, V)
    U_seq, lse_seq = tsmp.stl_mixer_fwd_ref(w, u1, V, True)
    assert U.dtype == tdt and U.shape == (BB, P, C)
    assert lse.dtype == torch.float32 and lse.shape == (BB, L)
    _close(lse, lse_seq, 1e-6, 1e-6, "lse vs sequential")
    _close(U, U_seq, ftol, ftol, "U vs sequential")
    U_jax, vjp = jax.vjp(jsmp._mixer, jw, ju1, jV)
    _close(U, U_jax, ftol, ftol, "U vs JAX")

    got = tsmp.stl_mixer_bwd_passes_ref(w, u1, V, dU, lse)
    want_seq = tsmp.stl_mixer_bwd_ref(w, u1, V, dU, lse_seq)
    want_jax = vjp(jdU)
    for nm, g, ws, wj, t in zip(("dw", "du1", "dV"), got, want_seq,
                                want_jax, (w, u1, V)):
        assert g.dtype == t.dtype and g.shape == t.shape, nm
        _close(g, ws, brtol, batol, f"{nm} vs sequential")
        _close(g, wj, brtol, batol, f"{nm} vs JAX")


@pytest.mark.parametrize("step,nw", [(64, 1), (64, 2), (32, 2), (32, 4)])
@pytest.mark.parametrize("P", [8, 40, 200])
def test_lane_statistics_merge_to_the_logsumexp(step, nw, P):
    """The rows pass's per-lane running max and sum, merged, give each
    row's log-sum-exp within 1e-6 relative: at P 8 with nw > 1 some lanes
    hold no column at all (their max stays -inf, their sum 0), and rows
    spanning +-60 rescale their sums as the max grows from step to step."""
    rng = np.random.default_rng(P * nw)
    S = torch.from_numpy(
        (rng.standard_normal((2, 5, P)) * np.array([1.0, 20.0])[:, None, None]
         + np.linspace(-40.0, 40.0, P)).astype(np.float32))
    got = tsmp._lane_stats(S, step, nw)
    want = torch.logsumexp(S.double(), dim=-1)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_plain_forward_statistics_are_the_softmax():
    """exp(S - lse) of the plain forward's lse is the softmax of S (within
    1e-6), and asking for the statistics leaves U's bits as they are."""
    w, u1, V, _ = (torch.from_numpy(a) for a in _args(2, 24, 40, 128))
    U, lse = tsmp.stl_mixer_fwd_ref(w, u1, V, True)
    S = w @ u1
    np.testing.assert_allclose(torch.exp(S - lse[..., None]).numpy(),
                               torch.softmax(S, dim=-1).numpy(), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(U, tsmp.stl_mixer_fwd_ref(w, u1, V))


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=str)
def test_plain_backward_from_lse_matches_its_softmax(tdt):
    """The plain backward with the forward's lse against the same backward
    taking the softmax itself: fp32 within 1e-5 (exp(S - lse) and the
    softmax differ in the last bits); bf16 within one bf16 step."""
    w, u1, V, dU = (torch.from_numpy(a).to(tdt) for a in _args(2, 32, 72, 128))
    lse = tsmp.stl_mixer_fwd_ref(w, u1, V, True)[1]
    tol = 1e-5 if tdt == torch.float32 else 2e-2
    for g, want in zip(tsmp.stl_mixer_bwd_ref(w, u1, V, dU, lse),
                       tsmp.stl_mixer_bwd_ref(w, u1, V, dU)):
        _close(g, want, tol, tol)


def test_stl_mixer_hands_the_forward_lse_to_the_backward(monkeypatch):
    """STLMixer saves the forward's lse and its backward passes it on: the
    plain backward receives exactly the plain forward's lse."""
    w, u1, V, dU = (torch.from_numpy(a) for a in _args(2, 16, 24, 128))
    seen = []
    orig = tsmp.stl_mixer_bwd_ref
    monkeypatch.setattr(tsmp, "stl_mixer_bwd_ref",
                        lambda *a: seen.append(a[4]) or orig(*a))
    leaves = [t.clone().requires_grad_(True) for t in (w, u1, V)]
    tsmp.STLMixer.apply(*leaves, "torch").backward(dU)
    assert len(seen) == 1
    assert torch.equal(seen[0], tsmp.stl_mixer_fwd_ref(w, u1, V, True)[1])
    assert all(t.grad is not None for t in leaves)


@pytest.mark.parametrize("lse,ok", [
    ((2, 16), True), ((2, 15), False), ((16,), False),
    ((2, 16, torch.bfloat16), False)], ids=["ok", "rows", "rank", "dtype"])
def test_wrapper_checks_the_lse(lse, ok):
    """The backward wrapper takes lse only as the forward gives it: [BB, L]
    fp32 beside the operands."""
    dtype = lse[-1] if isinstance(lse[-1], torch.dtype) else torch.float32
    shape = lse[:-1] if isinstance(lse[-1], torch.dtype) else lse
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    args = (z(2, 16, 128), z(128, 24), z(2, 16, 128), z(2, 24, 128))
    given = torch.zeros(*shape, dtype=dtype)
    if ok:
        tsmp._check_cuda_args(*args, lse=given)
        return
    with pytest.raises(ValueError, match="lse"):
        tsmp._check_cuda_args(*args, lse=given)


def test_twins_step_is_the_kernels():
    """The twins walk in the kernels' steps and warps per row: STEP and the
    channels a warp owns (128 bf16, 64 fp32) are Cfg's in
    csrc/stl_mixer_tiles.cuh."""
    src = (CSRC / "stl_mixer_tiles.cuh").read_text()
    step = re.search(r"kStep = kBf16 \? (\d+) : (\d+);", src)
    out = re.search(r"kOut = kBf16 \? (\d+) : (\d+);", src)
    assert step and out
    assert tsmp.STEP == {torch.bfloat16: int(step.group(1)),
                         torch.float32: int(step.group(2))}
    assert (int(out.group(1)), int(out.group(2))) == (128, 64)


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def _csrc_names():
    """The __global__ functions and the layout structs csrc/ defines."""
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    kernels = set()
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        if text.startswith("__launch_bounds__", i):   # skip (balanced)
            depth, i = 0, text.index("(", i)
            while True:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
                if depth == 0:
                    break
        kernels.add(re.match(r"\s*(\w+)\s*\(", text[i:]).group(1))
    layouts = set(re.findall(r"struct\s+(\w+Layout)\b", text))
    return kernels, layouts


def test_chip_smoke_profile_names_are_kernels_in_csrc(monkeypatch):
    """Every name chip_smoke looks for in a profile (the model paths' shares
    and the per-pass splits of 2, 2b, 2c/2d and 2f/2i) is a __global__
    kernel that csrc/ defines, or the layout type the SSD walks are
    instantiated with: a stale name would print an empty split."""
    cs = _chip_smoke(monkeypatch)
    kernels, layouts = _csrc_names()
    patterns = [p for _, (_, shares) in cs.PATHS.items()
                for names in shares.values() for p in names]
    for split in (cs.SSD_WALK_SPLIT, cs.SCAN_FWD_SPLIT, cs.SCAN_BWD_SPLIT,
                  cs.STL_FWD_SPLIT, cs.STL_BWD_SPLIT):
        patterns += list(split.values())
    assert patterns
    for p in patterns:
        base = p.split("<")[0].split("::")[-1]
        assert base in kernels or base in layouts, p
    shares = cs.PATHS[("st_ssd", cs.SIZE)][1]
    assert shares["stl mixer"] == tuple(cs.STL_FWD_SPLIT.values())
    assert shares["stl mixer backward"] == tuple(cs.STL_BWD_SPLIT.values())


_SASS = """
        code for sm_90a
                Function : _ZN9stl_mixer21mixer_fwd_rows_kernelI13__nv_bfloat16Li128EEEvPKT_S4_Pfii
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
                Function : _ZN9stl_mixer21mixer_fwd_cols_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_PKfPS2_ii
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN9stl_mixer21mixer_fwd_rows_kernelIfLi128EEEvPKT_S2_Pfii
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("bare", [False, True])
def test_chip_smoke_counts_the_mixer_passes_hmma(monkeypatch, bare):
    """chip_smoke reads each mixer pass's HMMA count per operand type and C
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
                cs._stl_mma("stl_mixer_fwd")
        else:
            assert cs._stl_mma("stl_mixer_fwd") == {
                "fp32": {"rows C128": 0},
                "bf16": {"rows C128": 2, "cols C256": 1}}
    finally:
        cs._stl_mma.cache_clear()
