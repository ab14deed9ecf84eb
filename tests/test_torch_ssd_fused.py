"""The plain versions of the single-layout fused SSD kernel (forward with
Ssave, and all seven backward cotangents) against the JAX package's
``ssd_fused`` run in Pallas interpret mode, as its own tests run it; the
autograd Function against torch.autograd through the plain forward; the
port's ``ssd_chunked`` on its fused path against the JAX one with
``_USE_SSD_FUSED`` (a padded last chunk included), values and gradients;
the card gates of the fused SSD and of Y_diag against their CUDA wrappers'
checks; and the wrappers' refusals on the CPU."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd as jssd
import medical_image_classification_tpu.kernels.ssd_fused_pallas as jsf
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_fused as tsf
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd

torch.set_num_threads(1)
NAMES = ("Cc", "Bc", "acum", "dte", "cdec", "dtp", "x")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsf, "_INTERPRET", True)
    monkeypatch.setattr(jsf, "_MIN_L", 8)
    monkeypatch.setattr(tsf, "_MIN_L", 8)


def _inputs(B=2, nc=3, l=16, H=4, P=8, N=128, seed=0):
    """The kernel's operands as ``ssd_chunked`` builds them: dtp a
    softplus, acum its cumsum against a negative A, dte and cdec from it."""
    rng = np.random.default_rng(seed)
    C, Bm = (0.3 * rng.standard_normal((2, B, nc, l, N))).astype(np.float32)
    dtp = np.log1p(np.exp(rng.standard_normal((B, nc, H, l)) - 1.0)).astype(
        np.float32)
    A = -(0.2 + 0.5 * rng.random(H)).astype(np.float32)
    acum = np.cumsum(dtp * A[:, None], -1).astype(np.float32)
    dte = np.exp(acum[..., -1:] - acum).astype(np.float32)
    cdec = np.exp(acum[..., -1]).astype(np.float32)
    x, dy = rng.standard_normal((2, B, nc, l, H * P)).astype(np.float32)
    return (C, Bm, acum, dte, cdec, dtp, x), dy


def _cast(args, jdt=None, tdt=None):
    """(C, B, x) in the operand dtype, the rows in fp32; JAX or torch."""
    mm = (0, 1, 6)
    if jdt is not None:
        return tuple(jnp.asarray(a, jdt if i in mm else jnp.float32)
                     for i, a in enumerate(args))
    return tuple(torch.from_numpy(a).to(tdt if i in mm else torch.float32)
                 for i, a in enumerate(args))


def _close(got, want, rtol, atol_rel, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32).reshape(got.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_rel * max(1.0, float(np.abs(want).max())), err_msg=what)


# (rtol, atol as a share of max(1, max|JAX|)).  fp32: the same products
# summed in other orders.  bf16: operands rounded at the same places on
# both sides (M, dtx, Sin, dtx_d, dYoff, dscores), so an output lands one
# bf16 step apart at worst where the two fp32 sums straddle a midpoint
CASES = [("fp32", jnp.float32, torch.float32, 1e-4, 1e-4),
         ("bf16", jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)]


@pytest.mark.parametrize("name,jdt,tdt,rtol,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_matches_jax(name, jdt, tdt, rtol, atol):
    args, _ = _inputs(seed=1)
    yj, Sj = jsf._run_fwd(*_cast(args, jdt=jdt), save=True)
    yt, St = tsf.ssd_fused_fwd(*_cast(args, tdt=tdt), want_save=True,
                               impl="torch")
    assert yt.dtype == St.dtype == tdt
    assert yt.shape == yj.shape and St.shape == Sj.shape
    _close(yt, yj, rtol, atol, "y")
    _close(St, Sj, rtol, atol, "Ssave")


@pytest.mark.parametrize("name,jdt,tdt,rtol,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_matches_jax_vjp(name, jdt, tdt, rtol, atol):
    """All seven cotangents, in ``_vjp_bwd``'s order, against jax.vjp of
    the JAX custom VJP (its Pallas backward kernel in interpret mode)."""
    args, dy = _inputs(seed=2)
    _, vjp = jax.vjp(jsf.ssd_fused, *_cast(args, jdt=jdt))
    want = vjp(jnp.asarray(dy, jdt))
    ta = _cast(args, tdt=tdt)
    _, Ssave = tsf.ssd_fused_fwd(*ta, want_save=True, impl="torch")
    got = tsf.ssd_fused_bwd(*ta, Ssave, torch.from_numpy(dy).to(tdt),
                            impl="torch")
    assert len(got) == len(want) == 7
    for nm, g, w, a in zip(NAMES, got, want, ta):
        assert g.shape == a.shape and g.dtype == a.dtype, nm
        _close(g, w, rtol, atol, nm)


def test_autograd_function_matches_autograd_of_plain_forward():
    """SSDFused (the plain backward) against torch.autograd through the
    plain forward, all seven inputs, fp32 (1e-4 of each gradient's scale:
    the same formulas summed in other orders)."""
    args, dy = _inputs(B=1, seed=3)
    g = torch.from_numpy(dy)

    def leaves():
        return [a.clone().requires_grad_(True)
                for a in _cast(args, tdt=torch.float32)]

    a1 = leaves()
    y = tsf.ssd_fused(*a1, impl="torch")
    assert type(y.grad_fn).__name__ == "SSDFusedBackward"
    y.backward(g)
    a2 = leaves()
    want = torch.autograd.grad(tsf.ssd_fused_fwd_ref(*a2), a2, g)
    for nm, x, w in zip(NAMES, a1, want):
        _close(x.grad, w.numpy(), 1e-4, 1e-4, nm)
    with torch.no_grad():
        assert tsf.ssd_fused(*a1, impl="torch").grad_fn is None


def _ssd_inputs(L, seed, N=128, B=2, H=4, P=8):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((B, L, H, P)),
        dt=0.5 * rng.standard_normal((B, L, H)) - 1.0,
        A=-rng.uniform(1.0, 4.0, H),
        Bm=0.3 * rng.standard_normal((B, L, 1, N)),
        Cm=0.3 * rng.standard_normal((B, L, 1, N)),
        D=rng.standard_normal(H), bias=rng.standard_normal(H))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _count_fused(monkeypatch):
    """Record the calls of the JAX and the port's fused entry points."""
    calls = []
    jref, tfwd = jsf.ssd_fused, tsf.ssd_fused_fwd_ref
    monkeypatch.setattr(jsf, "ssd_fused",
                        lambda *a: calls.append("jax") or jref(*a))
    monkeypatch.setattr(tsf, "ssd_fused_fwd_ref",
                        lambda *a, **k: calls.append("port") or tfwd(*a, **k))
    return calls


# L 300 at chunk 32 and N 128 (more than 256 steps, so two or more
# chunks): 32, padded to 10 chunks; L 288: 9 chunks, pad-free
@pytest.mark.parametrize("name,jdt,tdt,rtol,atol", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("L", [300, 288])
def test_ssd_chunked_fused_path_matches_jax(monkeypatch, name, jdt, tdt, rtol,
                                            atol, L):
    """Both sides take the fused path (checked by their calls), within the
    kernels' (rtol, atol): the port's cumsum is torch.cumsum, the JAX one a
    triangular matmul, so acum may differ in its last bits and a bf16 M or
    dtx round the other way."""
    assert tssd._pick_chunk(L, 32, 128) == 32
    calls = _count_fused(monkeypatch)
    a = _ssd_inputs(L, seed=L)
    (xj, xt), (Bj, Bt), (Cj, Ct) = (
        (jnp.asarray(a[k], jdt), torch.from_numpy(a[k]).to(tdt))
        for k in ("x", "Bm", "Cm"))
    want = jssd.ssd_chunked(xj, jnp.asarray(a["dt"]), jnp.asarray(a["A"]), Bj,
                            Cj, chunk_size=32, D=jnp.asarray(a["D"]),
                            dt_bias=jnp.asarray(a["bias"]))
    got = tssd.ssd_chunked(xt, torch.from_numpy(a["dt"]),
                           torch.from_numpy(a["A"]), Bt, Ct, 32,
                           torch.from_numpy(a["D"]),
                           torch.from_numpy(a["bias"]))
    assert calls == ["jax", "port"] and got.dtype == tdt
    assert got.shape == (2, L, 4, 8)
    _close(got, want, rtol, atol)


def test_ssd_chunked_fused_path_grads_match_jax(monkeypatch):
    """The gradients of ``ssd_chunked`` through ``SSDFused`` (autograd
    chains dacum, ddte and dcdec to the cumsum, then to dt, dt_bias and A)
    against jax.grad of the JAX one, over a padded last chunk, fp32, every
    input within 1e-3 x its max."""
    a = _ssd_inputs(300, seed=11, B=1)
    g = np.random.default_rng(12).standard_normal((1, 300, 4, 8)).astype(
        np.float32)

    def jloss(t):
        y = jssd.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             chunk_size=32, D=t["D"], dt_bias=t["bias"])
        return jnp.sum(y * g)

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in a.items()})
    calls = []
    bwd = tsf.ssd_fused_bwd
    monkeypatch.setattr(tsf, "ssd_fused_bwd",
                        lambda *x, **k: calls.append(1) or bwd(*x, **k))
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in a.items()}
    y = tssd.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], 32,
                         t["D"], t["bias"])
    (y * torch.from_numpy(g)).sum().backward()
    assert calls == [1]
    for k in a:
        _close(t[k].grad, want[k], 1e-3, 1e-3, k)


# --------------------------------------------------------------------------
# the card gates against the CUDA wrappers' checks


def _accepts(check, *args, **kw):
    try:
        check(*args, **kw)
    except (ValueError, TypeError):
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_ydiag_card_gate_agrees_with_the_kernels_checks(dtype):
    """On a card, ``ydiag_supported`` says yes exactly where its shape
    terms hold and the CUDA wrappers take the forward's and the backward's
    operands (checked on meta tensors: the checks are shape logic).  So
    ``ssd_chunked`` never sends the kernels a shape they refuse; where the
    gate says no it takes the einsum path.  MedSSD's N 512 (stage 2 at
    240x240: l 232, H 32, P 64) is taken."""
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")
    for l, N, P, H, BC in itertools.product(
            (224, 232, 256, 264), (64, 256, 512, 576), (8, 64, 72),
            (4, 32), (32, 65535, 65536)):
        ops = (meta(BC, l, N), meta(BC, l, N),
               meta(BC, H, l, dt=torch.float32), meta(BC, H, l, P))
        kernels = (_accepts(tyd._check_cuda_args, *ops)
                   and _accepts(tyd._check_cuda_args, *ops, meta(BC, H, l, P)))
        want = tyd.ydiag_supported(l, N, P, 1) and kernels
        got = tyd.ydiag_supported(l, N, P, 1, card=True, BC=BC, dtype=dtype)
        assert got == want, (l, N, P, H, BC, dtype)
    assert tyd.ydiag_supported(232, 512, 64, 1, card=True, BC=32,
                               dtype=dtype) == (dtype != torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_fused_card_gate_agrees_with_the_kernels_checks(dtype):
    """The same for ``ssd_fused_supported``: on a card it says yes exactly
    where its shape terms hold and the wrappers take the forward's and the
    backward's operands.  MedSSD's stage 1 at 240x240 (B 32, l 256, nc 4,
    H 16, P 64, N 512) is taken."""
    meta = lambda *s, dt=dtype: torch.empty(*s, dtype=dt, device="meta")
    f32 = torch.float32
    for l, N, P, nc, B in itertools.product(
            (196, 200, 256, 260), (128, 512, 640), (8, 32, 64),
            (1, 4), (32, 16384)):
        H = 4
        ops = (meta(B, nc, l, N), meta(B, nc, l, N),
               meta(B, nc, H, l, dt=f32), meta(B, nc, H, l, dt=f32),
               meta(B, nc, H, dt=f32), meta(B, nc, H, l, dt=f32),
               meta(B, nc, l, H * P))
        kernels = (_accepts(tsf._check_cuda_args, *ops)
                   and _accepts(tsf._check_cuda_args, *ops,
                                Ssave=meta(B, nc, H, P, N),
                                dy=meta(B, nc, l, H * P)))
        want = tsf.ssd_fused_supported(l, N, P, 1, nc) and kernels
        got = tsf.ssd_fused_supported(l, N, P, 1, nc, card=True, batch=B,
                                      dtype=dtype)
        assert got == want, (l, N, P, nc, B, dtype)
    assert tsf.ssd_fused_supported(256, 512, 64, 1, 4, card=True,
                                   batch=32, dtype=dtype) == (
        dtype != torch.float16)


def test_gate_terms_follow_the_jax_gate():
    """The shape terms of the two gates are the JAX ones (interpret mode
    standing in for the TPU backend; bf16, where the JAX fused gate keeps
    no fp32 term) over a grid of shapes inside their VMEM budgets."""
    import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jyd, "_INTERPRET", True)
        for l, N, P, nc in itertools.product(
                (8, 12, 100, 196, 198, 232, 256, 264), (64, 128, 192, 512),
                (8, 12, 64), (1, 2, 4)):
            assert tsf.ssd_fused_supported(l, N, P, 1, nc) == \
                jsf.ssd_fused_supported(l, N, P, 1, nc, 16, 2), (l, N, P, nc)
            assert tyd.ydiag_supported(l, N, P, 1) == \
                jyd.ydiag_supported(l, N, P, 1, 16, 2), (l, N, P)
        assert not tsf.ssd_fused_supported(256, 512, 64, 2, 4)


@pytest.mark.parametrize("fault", ["dtype", "noncontiguous", "headdim",
                                   "chunk", "state", "row_dtype", "row_shape",
                                   "x_dtype", "ssave", "dy"])
def test_kernel_wrapper_refuses_bad_input(fault):
    """The argument checks that run before any launch."""
    args, dy = _inputs(B=1, nc=2, l=16, H=2, P=32, N=128)
    ta = list(_cast(args, tdt=torch.float32))
    kw = {}
    if fault == "dtype":
        ta[0], ta[1] = ta[0].half(), ta[1].half()
    elif fault == "noncontiguous":
        ta[2] = ta[2].transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "headdim":              # P = 16, not a multiple of 32
        ta = list(_cast(_inputs(B=1, nc=2, l=16, H=2, P=16)[0],
                        tdt=torch.float32))
    elif fault == "chunk":
        ta = list(_cast(_inputs(B=1, nc=2, l=264, H=2, P=32)[0],
                        tdt=torch.float32))
    elif fault == "state":
        ta = list(_cast(_inputs(B=1, nc=2, l=16, H=2, P=32, N=640)[0],
                        tdt=torch.float32))
    elif fault == "row_dtype":
        ta[3] = ta[3].double()
    elif fault == "row_shape":
        ta[4] = ta[4][:, :1].contiguous()
    elif fault == "x_dtype":
        ta[6] = ta[6].bfloat16()
    elif fault == "ssave":
        kw["Ssave"] = torch.zeros(1, 2, 2, 32, 120)          # wrong N
        kw["dy"] = torch.from_numpy(dy)
    else:                                                   # wrong dtype
        kw["Ssave"] = torch.zeros(1, 2, 2, 32, 128)
        kw["dy"] = torch.from_numpy(dy).bfloat16()
    with pytest.raises((ValueError, TypeError)):
        tsf._check_cuda_args(*ta, **kw)
    if fault == "dy":                     # the same with dy right is taken
        tsf._check_cuda_args(*_cast(args, tdt=torch.float32),
                             Ssave=kw["Ssave"], dy=torch.from_numpy(dy))


def test_dispatcher_counts_no_launch_on_cpu_and_refuses_cuda():
    args, dy = _inputs(B=1, seed=4)
    ta = _cast(args, tdt=torch.float32)
    before = (tsf.ssd_fused_fwd.launches, tsf.ssd_fused_bwd.launches)
    y = tsf.ssd_fused(*ta)                          # auto -> plain on CPU
    assert y.shape == (1, 3, 16, 4 * 8) and y.grad_fn is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.ssd_fused(*ta, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.ssd_fused_bwd(*ta, None, torch.from_numpy(dy), impl="cuda")
    with pytest.raises(ValueError, match="unknown SSD impl"):
        tsf.ssd_fused(*ta, impl="pallas")
    assert (tsf.ssd_fused_fwd.launches,
            tsf.ssd_fused_bwd.launches) == before
