"""The plain versions of the ST-SSD slice's three kernels, forward and
backward, against the JAX package's Pallas kernels and their custom VJPs
(run in interpret mode, as the JAX package's own tests run them on the
CPU): Y_diag, the STL token mixer and the STF gate, in fp32 and bf16 on the
same seeded numpy inputs; the autograd Functions against torch.autograd
through the plain forwards, and the entry points' routing through them; the
port's ``ssd_chunked`` with its Y_diag branch against the JAX one with
``ydiag_fused``, values and gradients; the ST-SSD core stack; the gates at
st_ssd's stages; the wrappers' refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd as jssd
import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu.kernels.stf_zgate_pallas as jszp
import medical_image_classification_tpu.kernels.stl_mixer_pallas as jsmp
import medical_image_classification_tpu.ops.ss2d as jss2d
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
import medical_image_classification_tpu_torch.kernels.stf_zgate as tszp
import medical_image_classification_tpu_torch.kernels.stl_mixer as tsmp
import medical_image_classification_tpu_torch.ops.ss2d as tss2d
from medical_image_classification_tpu_torch.kernels import _dispatch

torch.set_num_threads(2)

# (dtype, rtol, atol as a share of max|JAX|).  fp32: the two sides sum the
# same fp32 products in other orders.  bf16: both round the same fp32 sums
# to bf16 at the same points (M, E, Z, the output), so a value lands one
# bf16 step (2^-8 relative) apart where the two sums straddle a midpoint
DTYPES = [("fp32", jnp.float32, torch.float32, 1e-5, 1e-5),
          ("bf16", jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jyd, jsmp, jszp):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _pair(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, rtol, atol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("l,H,P,N", [(32, 4, 8, 64), (56, 8, 64, 64),
                                     (40, 2, 16, 128), (24, 2, 8, 512)])
def test_ydiag_plain_matches_jax(case, l, H, P, N):
    _, jdt, tdt, rtol, atol = case
    rng = np.random.default_rng(l + H)
    BC = 3
    C, B = (0.3 * rng.standard_normal((2, BC, l, N))).astype(np.float32)
    acum = np.cumsum(-0.4 * rng.random((BC, H, l)), -1).astype(np.float32)
    dtx = rng.standard_normal((BC, H, l, P)).astype(np.float32)
    (Cj, Ct), (Bj, Bt), (xj, xt) = (_pair(a, jdt, tdt) for a in (C, B, dtx))
    want = jyd.ydiag_fused(Cj, Bj, jnp.asarray(acum), xj)
    got = tyd.ydiag_fused(Ct, Bt, torch.from_numpy(acum), xt)
    assert got.dtype == tdt and got.shape == (BC, H, l, P)
    _close(got, want, rtol, atol)


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("BB,L,P,C", [(2, 256, 384, 128), (1, 64, 200, 256)])
def test_stl_mixer_plain_matches_jax(case, BB, L, P, C):
    _, jdt, tdt, rtol, atol = case
    rng = np.random.default_rng(L + P)
    w = (0.5 * rng.standard_normal((BB, L, C))).astype(np.float32)
    u1 = rng.uniform(-0.08, 0.08, (C, P)).astype(np.float32)
    u2 = rng.uniform(-0.08, 0.08, (C, C)).astype(np.float32)
    (wj, wt), (u1j, u1t), (u2j, u2t) = (_pair(a, jdt, tdt)
                                        for a in (w, u1, u2))
    want = jsmp.stl_mixer(wj, u1j, u2j)
    got = tsmp.stl_mixer(wt, u1t, u2t)
    assert got.dtype == tdt and got.shape == (BB, P, C)
    _close(got, want, rtol, atol)


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("BB,P,C", [(2, 384, 128), (1, 200, 256)])
def test_stf_zgate_plain_matches_jax(case, BB, P, C):
    _, jdt, tdt, rtol, atol = case
    rng = np.random.default_rng(P + C)
    pT = (0.5 * rng.standard_normal((BB, P, C))).astype(np.float32)
    lz = rng.uniform(-0.1, 0.1, (C, P)).astype(np.float32)
    U = (0.5 * rng.standard_normal((BB, P, C))).astype(np.float32)
    (pj, pt), (lj, lt), (Uj, Ut) = (_pair(a, jdt, tdt) for a in (pT, lz, U))
    want = jszp.stf_zgate(pj, lj, Uj)
    got = tszp.stf_zgate_fwd(pt, lt, Ut)
    assert got.dtype == tdt and got.shape == (BB, P, C)
    _close(got, want, rtol, atol)


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
def test_ssd_chunked_ydiag_branch_matches_jax(monkeypatch, case):
    """L 384 at chunk 128 (three chunks, N 64): both sides take the Y_diag
    branch with the window widened to l >= 8 (the JAX test's setting)."""
    _, jdt, tdt, rtol, atol = case
    monkeypatch.setattr(jyd, "_MIN_L", 8)
    monkeypatch.setattr(tyd, "_MIN_L", 8)
    calls = []
    ref, jref = tyd.ydiag_fused_ref, jyd.ydiag_fused
    monkeypatch.setattr(tyd, "ydiag_fused_ref",
                        lambda *a: calls.append("port") or ref(*a))
    monkeypatch.setattr(jyd, "ydiag_fused",
                        lambda *a: calls.append("jax") or jref(*a))
    B, L, H, P, N = 2, 384, 4, 8, 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (0.5 * rng.standard_normal((B, L, H)) - 1.0).astype(np.float32)
    A = -rng.uniform(1.0, 4.0, H).astype(np.float32)
    Bm, Cm = (0.3 * rng.standard_normal((2, B, L, 1, N))).astype(np.float32)
    D, bias = rng.standard_normal((2, H)).astype(np.float32)
    (xj, xt), (Bj, Bt), (Cj, Ct) = (_pair(a, jdt, tdt) for a in (x, Bm, Cm))
    want = jssd.ssd_chunked(xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj,
                            chunk_size=128, D=jnp.asarray(D),
                            dt_bias=jnp.asarray(bias))
    got = tssd.ssd_chunked(xt, torch.from_numpy(dt), torch.from_numpy(A), Bt,
                           Ct, 128, torch.from_numpy(D),
                           torch.from_numpy(bias))
    assert calls == ["jax", "port"] and got.dtype == tdt
    _close(got, want, 5 * rtol, 5 * atol)


def test_core_scan_order_stack_matches_jax():
    """``ss2d_core_ssd(merge=False, stack_scan_order=True)``, the ST-SSD
    core: the per-direction outputs [B, 4, L, d_ssm] in scan order (the
    einsum path; fp32)."""
    rng = np.random.default_rng(4)
    nheads, headdim, d_state = 2, 8, 8
    d_ssm = nheads * headdim
    x = (0.5 * rng.standard_normal((2, 6, 6, d_ssm + 2 * d_state + nheads))
         ).astype(np.float32)
    ps = [rng.random((4, nheads)).astype(np.float32) for _ in range(3)]
    kw = dict(d_ssm=d_ssm, d_state=d_state, nheads=nheads, headdim=headdim,
              chunk_size=16, merge=False, stack_scan_order=True)
    want = jss2d.ss2d_core_ssd(jnp.asarray(x), *map(jnp.asarray, ps),
                               ngroups=1, **kw)
    got = tss2d.ss2d_core_ssd(torch.from_numpy(x),
                              *map(torch.from_numpy, ps), **kw)
    assert got.shape == (2, 4, 36, d_ssm)
    _close(got, want, 1e-4, 1e-4)


def test_gates_match_jax_at_st_ssd_stages():
    """st_ssd at 224x224, bf16: the port's three gates and the JAX ones
    (interpret mode standing in for the TPU backend) pick the same stages,
    so one forward launches 2 Y_diag (stage 0's two blocks), 4 STL-mixer
    and 4 STF-gate kernels (stages 0-1)."""
    depths, N, P = (2, 2, 4, 2), 64, 64
    launches = [0, 0, 0]
    for i, (hw, d_ssm) in enumerate(((56, 128), (28, 256), (14, 512),
                                     (7, 1024))):
        L, H = hw * hw, 4 * d_ssm // P
        l = tssd._pick_chunk(L, 256, N)
        assert l == jssd._pick_chunk(L, 256, N)
        got = (tyd.ydiag_supported(l, N, P, 1),
               tsmp.stl_mixer_supported(L, L, d_ssm),
               tszp.stf_zgate_supported(L, d_ssm))
        want = (jyd.ydiag_supported(l, N, P, 1, H, 2),
                jsmp.stl_mixer_supported(L, L, d_ssm, 2),
                jszp.stf_zgate_supported(L, d_ssm, 2))
        assert got == want, (i, got, want)
        launches = [n + depths[i] * g for n, g in zip(launches, got)]
    assert launches == [2, 4, 4]


# the backward: (rtol, atol as a share of max|JAX|) per dtype.  fp32: other
# summation orders.  bf16: both sides round M, E, dS and Z to bf16 at the
# same points, then sum up to l or P rounded products; where the two fp32
# sums straddle a rounding midpoint an operand lands one bf16 step away
BWD_TOL = {"fp32": (1e-4, 1e-5), "bf16": (3e-2, 3e-2)}


def _ydiag_args(rng, BC, l, H, P, N):
    C, B = (0.3 * rng.standard_normal((2, BC, l, N))).astype(np.float32)
    acum = np.cumsum(-0.4 * rng.random((BC, H, l)), -1).astype(np.float32)
    dtx, dy = rng.standard_normal((2, BC, H, l, P)).astype(np.float32)
    return (C, B, acum, dtx), dy


def _stl_args(rng, BB, L, P, C):
    w, V = (0.5 * rng.standard_normal((2, BB, L, C))).astype(np.float32)
    u1 = rng.uniform(-0.08, 0.08, (C, P)).astype(np.float32)
    dU = rng.standard_normal((BB, P, C)).astype(np.float32)
    return (w, u1, V), dU


def _stf_args(rng, BB, P, C):
    pT = (0.5 * rng.standard_normal((BB, P, C))).astype(np.float32)
    lz = rng.uniform(-0.1, 0.1, (C, P)).astype(np.float32)
    U, dY = rng.standard_normal((2, BB, P, C)).astype(np.float32)
    return (pT, lz, U), dY


# (name, JAX custom VJP, port plain backward, inputs, which operands carry
# the operand dtype: acum stays fp32 on both sides)
BWD_CASES = [
    ("ydiag", lambda: jyd.ydiag_fused, lambda: tyd.ydiag_fused_bwd_ref,
     lambda rng: _ydiag_args(rng, 3, 40, 4, 16, 64), (True, True, False,
                                                      True)),
    ("ydiag_wide_n", lambda: jyd.ydiag_fused, lambda: tyd.ydiag_fused_bwd_ref,
     lambda rng: _ydiag_args(rng, 2, 56, 2, 64, 128), (True, True, False,
                                                       True)),
    # MedSSD's state width (N 512: stage 2 at 240x240, stage 3 at 512x512)
    ("ydiag_n512", lambda: jyd.ydiag_fused, lambda: tyd.ydiag_fused_bwd_ref,
     lambda rng: _ydiag_args(rng, 2, 24, 2, 8, 512), (True, True, False,
                                                      True)),
    ("stl_mixer", lambda: jsmp._mixer, lambda: tsmp.stl_mixer_bwd_ref,
     lambda rng: _stl_args(rng, 2, 64, 200, 128), (True, True, True)),
    ("stl_mixer_c256", lambda: jsmp._mixer, lambda: tsmp.stl_mixer_bwd_ref,
     lambda rng: _stl_args(rng, 1, 48, 40, 256), (True, True, True)),
    ("stf_zgate", lambda: jszp.stf_zgate, lambda: tszp.stf_zgate_bwd_ref,
     lambda rng: _stf_args(rng, 2, 200, 128), (True, True, True)),
    ("stf_zgate_c256", lambda: jszp.stf_zgate, lambda: tszp.stf_zgate_bwd_ref,
     lambda rng: _stf_args(rng, 1, 40, 256), (True, True, True)),
]


@pytest.mark.parametrize("case", DTYPES, ids=[c[0] for c in DTYPES])
@pytest.mark.parametrize("name,jfn,tfn,make,cast", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_plain_backward_matches_jax_vjp(case, name, jfn, tfn, make, cast):
    """Each plain backward against jax.vjp of the JAX custom VJP (its
    Pallas backward kernel in interpret mode), every cotangent, the
    cotangent given in the operand dtype."""
    dt_name, jdt, tdt, _, _ = case
    rtol, atol = BWD_TOL[dt_name]
    args, g = make(np.random.default_rng(len(name)))
    jargs = [jnp.asarray(a, jdt if c else jnp.float32)
             for a, c in zip(args, cast)]
    targs = [torch.from_numpy(a).to(tdt if c else torch.float32)
             for a, c in zip(args, cast)]
    _, vjp = jax.vjp(jfn(), *jargs)
    want = vjp(jnp.asarray(g, jdt))
    got = tfn()(*targs, torch.from_numpy(g).to(tdt))
    assert len(got) == len(want) == len(args)
    for k, (gt, wt, t) in enumerate(zip(got, want, targs)):
        assert gt.dtype == t.dtype and gt.shape == t.shape, (k, gt.dtype)
        _close(gt, wt, rtol, atol)


# (name, Function entry taking (operands..., impl), plain forward, inputs)
FN_CASES = [
    ("ydiag", lambda *a: tyd.ydiag_fused(*a, impl="torch"),
     lambda: tyd.ydiag_fused_ref,
     lambda rng: _ydiag_args(rng, 2, 40, 4, 16, 64)),
    ("stl_mixer", lambda *a: tsmp.STLMixer.apply(*a, "torch"),
     lambda: tsmp.stl_mixer_fwd_ref,
     lambda rng: _stl_args(rng, 2, 64, 72, 128)),
    ("stf_zgate", lambda *a: tszp.stf_zgate(*a, impl="torch"),
     lambda: tszp.stf_zgate_fwd_ref,
     lambda rng: _stf_args(rng, 2, 72, 128)),
]


@pytest.mark.parametrize("name,entry,ref,make", FN_CASES,
                         ids=[c[0] for c in FN_CASES])
def test_functions_match_autograd(name, entry, ref, make):
    """YDiagFused, STLMixer and STFZGate (impl "torch": the plain backward)
    against torch.autograd through the plain forward, fp32, every operand's
    gradient within 1e-4 x its max (the same formulas summed in other
    orders; fp32 rounds nothing at the rounding points)."""
    args, g = make(np.random.default_rng(7))
    g = torch.from_numpy(g)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = entry(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(ref()(*leaves), leaves, g)
    for gt, wt in zip(got, want):
        _close(gt, wt.numpy(), 1e-4, 1e-4)


def _entries():
    """(name, entry(impl) on small fp32 operands that require grad, the
    Function's backward node name, the plain forward's module and name)."""
    rng = np.random.default_rng(9)
    yd, _ = _ydiag_args(rng, 1, 16, 2, 8, 64)
    stl, _ = _stl_args(rng, 2, 16, 8, 128)
    stf, _ = _stf_args(rng, 2, 8, 128)
    u2 = rng.uniform(-0.1, 0.1, (128, 128)).astype(np.float32)
    leaf = lambda a: torch.from_numpy(a).requires_grad_(True)
    return [
        ("ydiag", lambda impl: tyd.ydiag_fused(*map(leaf, yd), impl),
         "YDiagFusedBackward", tyd, "ydiag_fused_fwd"),
        ("stl_mixer", lambda impl: tsmp.stl_mixer(leaf(stl[0]), leaf(stl[1]),
                                                  leaf(u2), impl),
         "STLMixerBackward", tsmp, "stl_mixer_fwd"),
        ("stf_zgate", lambda impl: tszp.stf_zgate(*map(leaf, stf), impl),
         "STFZGateBackward", tszp, "stf_zgate_fwd")]


@pytest.mark.parametrize("idx", range(3), ids=["ydiag", "stl_mixer",
                                               "stf_zgate"])
def test_entries_route_through_functions(monkeypatch, idx):
    """Under autograd each entry point goes through its Function, so its
    output has the Function's grad_fn and a backward reaches every operand
    (an output without a grad_fn would drop its operands' gradients without
    an error).  Under no_grad and inference_mode it calls the forward
    dispatcher only, and the output has no grad_fn."""
    name, run, node, mod, fwd = _entries()[idx]
    calls = []
    orig = getattr(mod, fwd)
    monkeypatch.setattr(mod, fwd, lambda *a, **k: calls.append(1)
                        or orig(*a, **k))
    out = run("auto")
    assert type(out.grad_fn).__name__ == node, out.grad_fn
    out.sum().backward()
    assert calls == [1]
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = run("auto")
        assert out.grad_fn is None
    assert calls == [1, 1, 1]


def test_ssd_chunked_ydiag_branch_grads_match_jax(monkeypatch):
    """The gradients of ``ssd_chunked`` through its Y_diag branch (the
    Function's dacum carries A_cum's cotangent on to dt, dt_bias and A)
    against jax.grad of the JAX one with ``ydiag_fused``, fp32, every input
    within 1e-3 x its max."""
    monkeypatch.setattr(jyd, "_MIN_L", 8)
    monkeypatch.setattr(tyd, "_MIN_L", 8)
    B, L, H, P, N = 1, 192, 2, 8, 64
    rng = np.random.default_rng(11)
    arrs = dict(
        x=rng.standard_normal((B, L, H, P)),
        dt=0.5 * rng.standard_normal((B, L, H)) - 1.0,
        A=-rng.uniform(1.0, 4.0, H), Bm=0.3 * rng.standard_normal((B, L, 1, N)),
        Cm=0.3 * rng.standard_normal((B, L, 1, N)),
        D=rng.standard_normal(H), bias=rng.standard_normal(H))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    g = rng.standard_normal((B, L, H, P)).astype(np.float32)

    def jloss(a):
        y = jssd.ssd_chunked(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"],
                             chunk_size=64, D=a["D"], dt_bias=a["bias"])
        return jnp.sum(y * g)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in arrs.items()})
    calls = []
    bwd = tyd.ydiag_fused_bwd
    monkeypatch.setattr(tyd, "ydiag_fused_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrs.items()}
    y = tssd.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], 64,
                         t["D"], t["bias"])
    (y * torch.from_numpy(g)).sum().backward()
    assert calls == [1]                  # three chunks of 64, one call
    for k in arrs:
        _close(t[k].grad, want[k], 1e-3, 1e-3)


def _bad_cases():
    f32, bf = torch.float32, torch.bfloat16
    z = lambda *s, dt=f32: torch.zeros(*s, dtype=dt)
    ok_yd = (z(2, 32, 64), z(2, 32, 64), z(2, 4, 32), z(2, 4, 32, 8))
    ok_stl = (z(2, 16, 128), z(128, 24), z(2, 16, 128))
    ok_stf = (z(2, 24, 128), z(128, 24), z(2, 24, 128))
    yield "ydiag ok", tyd._check_cuda_args, ok_yd, None
    yield "ydiag N", tyd._check_cuda_args, (
        z(2, 32, 576), z(2, 32, 576)) + ok_yd[2:], ValueError
    yield "ydiag dtype", tyd._check_cuda_args, (
        z(2, 32, 64, dt=torch.float16),) * 2 + ok_yd[2:], TypeError
    yield "ydiag acum", tyd._check_cuda_args, ok_yd[:2] + (
        z(2, 4, 32, dt=bf), ok_yd[3]), ValueError
    yield "ydiag contiguous", tyd._check_cuda_args, ok_yd[:3] + (
        z(2, 4, 8, 32).transpose(2, 3),), ValueError
    # contiguous, but 4 bytes off the 16-byte vectors the kernels load
    yield "ydiag aligned", tyd._check_cuda_args, (
        z(2 * 32 * 64 + 1)[1:].view(2, 32, 64),) + ok_yd[1:], ValueError
    yield "stl ok", tsmp._check_cuda_args, ok_stl, None
    yield "stl C", tsmp._check_cuda_args, (
        z(2, 16, 384), z(384, 24), z(2, 16, 384)), ValueError
    yield "stl P", tsmp._check_cuda_args, (
        ok_stl[0], z(128, 20), ok_stl[2]), ValueError
    yield "stl V dtype", tsmp._check_cuda_args, ok_stl[:2] + (
        z(2, 16, 128, dt=bf),), ValueError
    yield "stf ok", tszp._check_cuda_args, ok_stf, None
    yield "stf C", tszp._check_cuda_args, (
        z(2, 24, 64), z(64, 24), z(2, 24, 64)), ValueError
    yield "stf U", tszp._check_cuda_args, ok_stf[:2] + (
        z(2, 16, 128),), ValueError
    # the backward kernels' cotangents and limits
    yield "ydiag bwd ok", tyd._check_cuda_args, ok_yd + (ok_yd[3],), None
    yield "ydiag bwd P", tyd._check_cuda_args, ok_yd[:3] + (
        z(2, 4, 32, 72), z(2, 4, 32, 72)), ValueError
    yield "ydiag bwd l", tyd._check_cuda_args, (
        z(2, 264, 64), z(2, 264, 64), z(2, 4, 264), z(2, 4, 264, 8),
        z(2, 4, 264, 8)), ValueError
    yield "ydiag bwd dy", tyd._check_cuda_args, ok_yd + (
        z(2, 4, 32, 8, dt=bf),), ValueError
    yield "stl bwd ok", tsmp._check_cuda_args, ok_stl + (
        z(2, 24, 128),), None
    yield "stl bwd dU", tsmp._check_cuda_args, ok_stl + (
        z(2, 16, 128),), ValueError
    yield "stf bwd ok", tszp._check_cuda_args, ok_stf + (ok_stf[2],), None
    yield "stf bwd dY", tszp._check_cuda_args, ok_stf + (
        z(2, 24, 128)[:, ::2],), ValueError


@pytest.mark.parametrize("name,check,args,exc",
                         list(_bad_cases()), ids=[c[0] for c in _bad_cases()])
def test_wrapper_checks(name, check, args, exc):
    if exc is None:
        check(*args)
    else:
        with pytest.raises(exc):
            check(*args)


def test_dense_copies_only_what_the_kernels_cannot_read():
    """The dispatchers hand the kernels ``dense`` operands: a contiguous,
    16-byte aligned tensor as it is; a strided or misaligned one copied."""
    t = torch.zeros(4, 8)
    assert _dispatch.dense(t) is t
    for view in (torch.arange(33.0)[1:].view(4, 8), torch.zeros(8, 4).t()):
        d = _dispatch.dense(view)
        assert d.is_contiguous() and d.data_ptr() % 16 == 0
        assert torch.equal(d, view)


def test_dispatch_refusals():
    """impl 'cuda' on a CPU tensor and an unknown impl raise in every
    entry point and in every backward dispatcher (whose routing under
    autograd ``test_entries_route_through_functions`` checks)."""
    t = torch.zeros(2, 16, 128)
    calls = [lambda impl: tyd.ydiag_fused(torch.zeros(1, 8, 64),
                                          torch.zeros(1, 8, 64),
                                          torch.zeros(1, 2, 8),
                                          torch.zeros(1, 2, 8, 8), impl),
             lambda impl: tsmp.stl_mixer(t, torch.zeros(128, 8),
                                         torch.zeros(128, 128), impl),
             lambda impl: tszp.stf_zgate_fwd(torch.zeros(2, 8, 128),
                                             torch.zeros(128, 8),
                                             torch.zeros(2, 8, 128), impl)]
    calls += [lambda impl: tyd.ydiag_fused_bwd(torch.zeros(1, 8, 64),
                                               torch.zeros(1, 8, 64),
                                               torch.zeros(1, 2, 8),
                                               torch.zeros(1, 2, 8, 8),
                                               torch.zeros(1, 2, 8, 8), impl),
              lambda impl: tsmp.stl_mixer_bwd(t, torch.zeros(128, 8), t,
                                              torch.zeros(2, 8, 128), impl),
              lambda impl: tszp.stf_zgate_bwd(*(torch.zeros(2, 8, 128),
                                                torch.zeros(128, 8))
                                              + (torch.zeros(2, 8, 128),) * 2,
                                              impl)]
    for call in calls:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call("cuda")
        with pytest.raises(ValueError, match="unknown"):
            call("triton")
        call("auto")
