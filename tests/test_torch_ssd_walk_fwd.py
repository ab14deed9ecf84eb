"""The plain twin of the SSD chunk walk's forward in the order of the CUDA
kernels' decomposition (``kernels/ssd_fused.py::walk_fwd_chunked_ref``:
every chunk's state increment at once, the fp32 carry, then every chunk's
y at once) against the sequential twin ``walk_fwd_ref``, y and Ssave, over
both operand layouts: the single layout (a ragged last chunk padded as
``ssd_chunked`` pads it) and the four-direction stack with its D skip and
mirrored reverse-class heads.  At one small shape per layout it also
stands in for the sequential walk under the JAX package's forwards, run in
Pallas interpret mode.  Then chip_smoke's view of the forward: the profile
names of its passes against the kernels ``csrc/`` defines, each pass's HMMA
count from SASS, and the byte count of the bound of the call that saves
the states."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.kernels.ssd_fused_pallas as jsf
from medical_image_classification_tpu_torch.kernels import ssd_fused as sf
from medical_image_classification_tpu_torch.kernels import ssd_fused_dirs as sfd

torch.set_num_threads(2)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CSRC = os.path.join(os.path.dirname(sf.__file__), os.pardir, "csrc")


def _rows(rng, B, nc, H, l, live):
    """dtp a softplus (zero on the padded steps), acum its cumsum against
    a negative A, dte, cdec."""
    dtp = np.log1p(np.exp(rng.standard_normal((B, nc, H, l)) - 1.0)) * live
    A = -(0.2 + 0.5 * rng.random(H))
    acum = np.cumsum(dtp * A[:, None], -1)
    dte = np.exp(acum[..., -1:] - acum)
    cdec = np.exp(acum[..., -1])
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (acum, dte, cdec, dtp))


def _walk_inputs(layout, B, nc, H, l, P, N, pad, mm, seed):
    """The walk's operands in scan-position order, fp32 holding exact
    values of ``mm``: (x, Bf, Cf, acum, dte, cdec, dtp, Dsk).  The single
    layout zeroes the last ``pad`` steps of the last chunk (x, B, C and
    dt), as ``ssd_chunked`` pads a ragged sequence; the dirs layout cuts x
    and the coupled B/C rows from a role-major stack and adds a D skip."""
    rng = np.random.default_rng(seed)
    live = (np.arange(nc * l) < nc * l - pad).reshape(nc, l)
    acum, dte, cdec, dtp = _rows(rng, B, nc, H, l, live[None, :, None])
    if layout == "dirs":
        nh, gn = H // 4, N // 4
        stack = torch.from_numpy((0.5 * rng.standard_normal(
            (B, nc, l, 2 * (nh * P + 2 * gn + nh)))).astype(np.float32))
        x, Bf, Cf = sfd._operands(stack.to(mm), nh * P, gn, H)
        Dsk = torch.from_numpy(rng.random(H).astype(np.float32))
    else:
        m = torch.from_numpy(live.astype(np.float32))
        x, Bf, Cf = (torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32)).to(mm).float()
            for s, shape in ((1.0, (B, nc, H, l, P)), (0.3, (B, nc, l, N)),
                             (0.3, (B, nc, l, N))))
        x, Bf, Cf = x * m[:, None, :, None], Bf * m[..., None], \
            Cf * m[..., None]
        Dsk = None
    return x, Bf, Cf, acum, dte, cdec, dtp, Dsk


# (layout, B, nc, H, l, P, N, pad): one, two and three chunks; l 20 and 12
# are not multiples of 16 (the kernels' ragged row tiles); N 96 is a
# multiple of 32 but not of 64 (a half-empty N tile); pad 7 leaves the last
# chunk ragged
SHAPES = [("flat", 2, 1, 4, 16, 8, 128, 0), ("flat", 2, 2, 3, 20, 8, 96, 0),
          ("flat", 1, 3, 2, 12, 16, 64, 7), ("dirs", 2, 1, 8, 16, 8, 128, 0),
          ("dirs", 1, 2, 4, 20, 8, 96, 0), ("dirs", 2, 3, 8, 12, 16, 64, 0)]


@pytest.mark.parametrize("dt_name", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["-".join(map(str, s)) for s in SHAPES])
def test_chunked_twin_matches_sequential_walk(shape, dt_name):
    """y and Ssave of the decomposition against the sequential walk.
    fp32: the same products summed in other orders, within 1e-5 of each
    output's max.  bf16: operands rounded at the same places on both sides
    (M, dtx, rnd(dtx dte), rnd(S)), so an output lands one bf16 step apart
    at worst where the two fp32 sums straddle a midpoint (rtol 3e-2, atol
    5e-2, as the dirs tests hold bf16)."""
    layout, *dims, pad = shape
    mm = DTYPES[dt_name]
    *ops, Dsk = _walk_inputs(layout, *dims, pad, mm, seed=sum(dims))
    want = sf.walk_fwd_ref(*ops, mm, Dsk, want_save=True)
    got = sf.walk_fwd_chunked_ref(*ops, mm, Dsk, want_save=True)
    assert sf.walk_fwd_chunked_ref(*ops, mm, Dsk)[1] is None
    for nm, g, w in zip(("y", "Ssave"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == mm, nm
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
# hold their plain forwards against the JAX ones
JAX_CASES = [("fp32", jnp.float32, 1e-4, 1e-4),
             ("bf16", jnp.bfloat16, 3e-2, 3e-2)]


@pytest.mark.parametrize("name,jdt,rtol,atol", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_flat_forward_with_chunked_twin_matches_jax(monkeypatch, name, jdt,
                                                    rtol, atol):
    """``ssd_fused_fwd_ref`` with the decomposition in place of the
    sequential walk: y and Ssave against the JAX ``_run_fwd`` (its Pallas
    forward in interpret mode)."""
    monkeypatch.setattr(jsf, "_INTERPRET", True)
    monkeypatch.setattr(jsf, "_MIN_L", 8)
    monkeypatch.setattr(sf, "walk_fwd_ref", sf.walk_fwd_chunked_ref)
    rng = np.random.default_rng(5)
    B, nc, l, H, P, N = 2, 3, 12, 4, 8, 128
    C, Bm = (0.3 * rng.standard_normal((2, B, nc, l, N))).astype(np.float32)
    rows = [r.numpy() for r in _rows(rng, B, nc, H, l, 1.0)]
    x = rng.standard_normal((B, nc, l, H * P)).astype(np.float32)
    args = (C, Bm, *rows, x)
    mm = (0, 1, 6)
    yj, Sj = jsf._run_fwd(*(jnp.asarray(a, jdt if i in mm else jnp.float32)
                            for i, a in enumerate(args)), save=True)
    tdt = DTYPES[name]
    yt, St = sf.ssd_fused_fwd_ref(
        *(torch.from_numpy(a).to(tdt if i in mm else torch.float32)
          for i, a in enumerate(args)), want_save=True)
    _close(yt, yj, rtol, atol, "y")
    _close(St, Sj, rtol, atol, "Ssave")


@pytest.mark.parametrize("name,jdt,rtol,atol", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_dirs_forward_with_chunked_twin_matches_jax(monkeypatch, name, jdt,
                                                    rtol, atol):
    """``ssd_fused_dirs_fwd_ref`` with the decomposition in place of the
    sequential walk: y (the D skip and the mirrored reverse class
    included) and Ssave against the JAX ``_run_fwd`` in interpret mode."""
    monkeypatch.setattr(jsfd, "_INTERPRET", True)
    monkeypatch.setattr(jsfd, "_MIN_L", 8)
    monkeypatch.setattr(sfd, "walk_fwd_ref", sf.walk_fwd_chunked_ref)
    rng = np.random.default_rng(6)
    B, nc, l, nh, P, gn = 2, 2, 12, 4, 8, 32
    H4, d_ssm = 4 * nh, nh * P
    stack = (0.5 * rng.standard_normal(
        (B, nc, l, 2 * (d_ssm + 2 * gn + nh)))).astype(np.float32)
    rows = [r.numpy() for r in _rows(rng, B, nc, H4, l, 1.0)]
    D = rng.random(H4).astype(np.float32)
    yj, Sj = jsfd._run_fwd(jnp.asarray(stack, jdt), *map(jnp.asarray, rows),
                           jnp.asarray(D)[None, None], d_ssm, gn, save=True)
    tdt = DTYPES[name]
    yt, St = sfd.ssd_fused_dirs_fwd_ref(
        torch.from_numpy(stack).to(tdt), *map(torch.from_numpy, rows),
        torch.from_numpy(D), d_ssm, gn, want_save=True)
    _close(yt, yj, rtol, atol, "y")
    _close(St, Sj, rtol, atol, "Ssave")


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _defined(header):
    """The __global__ kernels a csrc/ header defines, in order."""
    with open(os.path.join(CSRC, header)) as f:
        return re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                          r"(\w+_kernel)\(", f.read())


def test_chip_smoke_names_the_forward_passes(monkeypatch):
    """The profile patterns of the forward (the 2c/2k split and the medssd
    step's "ssd scores" and "ssd forward" shares) name the kernels that
    csrc/ssd_walk_fwd.cuh and the shared csrc/ssd_walk_tiles.cuh define,
    in launch order, and the passes that ``fwd_pass_info`` reports; no
    share counts the gram pass twice."""
    cs = _chip_smoke(monkeypatch)
    fwd = [f"fwd::{k}" for k in _defined("ssd_walk_fwd.cuh")]
    assert _defined("ssd_walk_tiles.cuh") == ["gram_kernel"]
    assert cs.SSD_GRAM == "tiles::gram_kernel"
    assert list(cs.SSD_FWD_KERNELS) == fwd[:1] + [cs.SSD_GRAM] + fwd[1:]
    assert list(cs.SSD_FWD_SPLIT) == list(sf.FWD_PASSES)
    assert list(cs.SSD_FWD_SPLIT.values()) == list(cs.SSD_FWD_KERNELS)
    shares = cs.PATHS[("medssd", cs.SIZE)][1]
    assert shares["ssd scores"] == (cs.SSD_GRAM,)
    assert shares["ssd forward"] == tuple(fwd)
    pats = [p for names in shares.values() for p in names]
    assert len(pats) == len(set(pats))


def test_chip_smoke_splits_a_forward_call(monkeypatch):
    """2c/2k's split profiles two calls and files each forward pass's mean
    device time a launch under its label."""
    cs = _chip_smoke(monkeypatch)
    calls = []

    def fake_profile(fn):
        fn()
        return [dict(name=f"void ssd_walk::{k}<__nv_bfloat16, ssd_walk::"
                     f"FlatLayout<__nv_bfloat16> >(...)", count=2,
                     device_us=1000.0 * (i + 1), cpu_us=0.0)
                for i, k in enumerate(cs.SSD_FWD_KERNELS)]

    monkeypatch.setattr(cs, "_profile", fake_profile)
    case = {"dtype": "bf16"}
    cs._walk_split(case, lambda: calls.append(1), cs.SSD_FWD_SPLIT)
    assert len(calls) == 2
    assert case["split"] == {p: (i + 1) / 2
                             for i, p in enumerate(sf.FWD_PASSES)}


_SASS = """
        code for sm_90a
                Function : _ZN8ssd_walk5tiles11gram_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvPKT_S7_PfNS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN8ssd_walk3fwd11prep_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvT0_PKfS7_PT_SA_NS_4DimsE
        /*0100*/                   FMUL R4, R8, R12 ;
                Function : _ZN8ssd_walk3fwd12state_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvPKT_PKfS7_PS5_NS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
                Function : _ZN8ssd_walk3fwd10out_kernelI13__nv_bfloat16NS_10DirsLayoutIS2_EEEEvT0_PKT_PKfSA_S7_S7_PS5_NS_4DimsE
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
                Function : _ZN8ssd_walk3fwd10out_kernelIfNS_10DirsLayoutIfEEEEvT0_PKT_PKfS8_S5_S5_PS3_NS_4DimsE
        /*0100*/                   FFMA R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("bare", [False, True])
def test_chip_smoke_counts_each_forward_pass_tensor_core_instructions(
        monkeypatch, bare):
    """chip_smoke reads each forward pass's HMMA count from the built
    library's SASS, per operand type, and fails where a bf16 pass that
    computes a product (every pass but prep) has none."""
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
                cs._ssd_mma("ssd_fused_dirs_fwd")
        else:
            assert cs._ssd_mma("ssd_fused_dirs_fwd") == {
                "fp32": {"out": 0},
                "bf16": {"gram": 1, "prep": 0, "state": 2, "out": 1}}
    finally:
        cs._ssd_mma.cache_clear()


def test_chip_smoke_bound_counts_the_saved_states(monkeypatch):
    """The bound of the forward that training runs writes Ssave besides y:
    at B 2, nc 3, l 8, H 4, P 32, N 64 in bf16 that is 2 x 3 x 4 x 32 x 64
    x 2 bytes more than the eval call's, and the eval call's bytes are
    the operands, the fp32 rows and y, each once."""
    cs = _chip_smoke(monkeypatch)
    B, nc, l, H, P, N, isz = 2, 3, 8, 4, 32, 64, 2
    ops = 1000
    eval_ms, by = cs._walk_bound(ops, B, nc, l, H, P, N, isz, "bf16", False)
    save_ms, by2 = cs._walk_bound(ops, B, nc, l, H, P, N, isz, "bf16", False,
                                  save=True)
    assert by == by2 == "bytes"
    rows = 3 * B * nc * H * l * 4 + B * nc * H * 4
    y = B * nc * l * H * P * isz
    assert eval_ms == pytest.approx((ops + rows + y) / cs.HBM_BPS * 1e3)
    assert save_ms - eval_ms == pytest.approx(
        B * nc * H * P * N * isz / cs.HBM_BPS * 1e3)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_chip_smoke_dirs_bound_takes_n_from_the_case(monkeypatch, backward):
    """The dirs SSD's bound at the d_state-16 models' stage 0 (B 32, L 3136
    over 14 chunks of 224, H4 8, d_ssm 128, P 64) at N 64 (gn 16), on meta
    tensors: N comes from the case, not from MedSSD's gn 128, and the
    bound is the larger of the bytes time and the operations time (the
    walk's causal pairs, the state products at N 64), with its label."""
    cs = _chip_smoke(monkeypatch)
    B, nc, l, H4, d_ssm, gn = 32, 14, 224, 8, 128, 16
    P, N = d_ssm // (H4 // 4), 4 * gn
    meta = dict(device="meta")
    stack = torch.empty(B, nc, l, 2 * (d_ssm + 2 * gn + H4 // 4),
                        dtype=torch.bfloat16, **meta)
    acum = torch.empty(B, nc, H4, l, **meta)
    args = (stack, acum)
    got = cs._ssd_bound(args, d_ssm, N, "bf16", backward)
    pairs = l * (l + 1) // 2
    rows = 3 * B * nc * H4 * l * 4 + B * nc * H4 * 4
    y = B * nc * l * H4 * P * 2
    ssave = B * nc * H4 * P * N * 2
    operands = stack.numel() * 2
    if backward:
        nbytes = 2 * operands + 2 * rows + ssave + y
        ops = B * nc * (6 * pairs * N + H4 * (4 * pairs * P + 10 * l * N * P))
    else:
        nbytes = operands + rows + y
        ops = B * nc * (2 * pairs * N + H4 * (2 * pairs * P + 4 * l * N * P))
    t_bytes = nbytes / cs.HBM_BPS * 1e3
    t_ops = ops / cs.PEAK_OPS["bf16"] * 1e3
    want = max(t_bytes, t_ops)
    assert got[0] == pytest.approx(want)
    assert got[1] == ("bytes" if t_bytes >= t_ops else "operations")
    assert cs._ssd_bound(args, d_ssm, 4 * cs.SSD_GN, "bf16", backward)[0] \
        > got[0]
    assert cs.SSD16_STAGES[0] == (nc * l, l, H4, d_ssm, gn)
