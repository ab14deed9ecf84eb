"""The plain twin of the four-direction fused SSD kernel (forward, Ssave
and all six backward cotangents) against the JAX package's
``ssd_fused_dirs`` run in Pallas interpret mode, as its own tests run it;
the autograd Function against torch.autograd through the plain forward;
and the CUDA wrappers' refusals on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
from medical_image_classification_tpu_torch.kernels import ssd_fused_dirs as tsf

torch.set_num_threads(2)
NAMES = ("stackr", "acum", "dte", "cdec", "dtp", "Dsk")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsfd, "_INTERPRET", True)
    monkeypatch.setattr(jsfd, "_MIN_L", 8)


def _inputs(B=2, L=64, l=16, nh=4, P=8, gn=32, seed=0):
    """Consistent inputs of the JAX test's reduced shape: dtp = softplus of
    a normal draw, acum its cumsum against a negative A."""
    rng = np.random.default_rng(seed)
    nc, H4, d_ssm = L // l, 4 * nh, nh * P
    stack = (0.5 * rng.standard_normal(
        (B, nc, l, 2 * (d_ssm + 2 * gn + nh)))).astype(np.float32)
    dtp = np.log1p(np.exp(rng.standard_normal((B, nc, H4, l)))).astype(
        np.float32)
    A = -(0.2 + 0.5 * rng.random(H4)).astype(np.float32)
    acum = np.cumsum(dtp * A[:, None], -1).astype(np.float32)
    dte = np.exp(acum[..., -1:] - acum).astype(np.float32)
    cdec = np.exp(acum[..., -1]).astype(np.float32)
    D = rng.random(H4).astype(np.float32)
    dy = rng.standard_normal((B, nc, l, H4 * P)).astype(np.float32)
    return (stack, acum, dte, cdec, dtp, D), dy, d_ssm, gn


def _jax(args, dtype):
    stack, acum, dte, cdec, dtp, D = args
    return (jnp.asarray(stack, dtype), jnp.asarray(acum), jnp.asarray(dte),
            jnp.asarray(cdec), jnp.asarray(dtp), jnp.asarray(D)[None, None])


def _torch(args, dtype):
    return tuple(torch.from_numpy(a).to(dtype if i == 0 else torch.float32)
                 for i, a in enumerate(args))


def _close(got, want, rtol, atol_rel=None, atol=None, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32).reshape(got.shape)
    if atol is None:
        atol = atol_rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# fp32: the same products summed in other orders, held at 1e-4 relative
# to each output's scale; bf16: operands rounded at the same places on
# both sides, outputs one bf16 step apart at worst
CASES = [("fp32", jnp.float32, torch.float32, 1e-4, 1e-4, None),
         ("bf16", jnp.bfloat16, torch.bfloat16, 3e-2, None, 5e-2)]


@pytest.mark.parametrize("name,jdt,tdt,rtol,atol_rel,atol", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("nh", [4, 8])
def test_forward_matches_jax(name, jdt, tdt, rtol, atol_rel, atol, nh):
    args, _, d_ssm, gn = _inputs(nh=nh, seed=nh)
    yj, Sj = jsfd._run_fwd(*_jax(args, jdt), d_ssm, gn, save=True)
    yt, St = tsf.ssd_fused_dirs_fwd(*_torch(args, tdt), d_ssm, gn,
                                    want_save=True, impl="torch")
    assert yt.dtype == St.dtype == tdt
    assert yt.shape == yj.shape and St.shape == Sj.shape
    _close(yt, yj, rtol, atol_rel, atol, "y")
    _close(St, Sj, rtol, atol_rel, atol, "Ssave")


@pytest.mark.parametrize("name,jdt,tdt,rtol,atol_rel,atol", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("nh", [4, 8])
def test_backward_matches_jax_vjp(name, jdt, tdt, rtol, atol_rel, atol, nh):
    args, dy, d_ssm, gn = _inputs(nh=nh, seed=10 + nh)
    ja = _jax(args, jdt)
    _, vjp = jax.vjp(lambda *z: jsfd.ssd_fused_dirs(*z, d_ssm, gn), *ja)
    want = vjp(jnp.asarray(dy, jdt))
    ta = _torch(args, tdt)
    _, Ssave = tsf.ssd_fused_dirs_fwd(*ta, d_ssm, gn, want_save=True,
                                      impl="torch")
    got = tsf.ssd_fused_dirs_bwd(*ta, d_ssm, gn, Ssave,
                                 torch.from_numpy(dy).to(tdt), impl="torch")
    assert len(got) == 6
    for nm, g, w, a in zip(NAMES, got, want, ta):
        assert g.shape == a.shape and g.dtype == a.dtype, nm
        _close(g, w, rtol, atol_rel, atol, nm)


def test_autograd_function_matches_autograd_of_plain_forward():
    """SSDFusedDirs (the plain backward) against torch.autograd through the
    plain forward, all six inputs, fp32 (1e-4 of each gradient's scale)."""
    args, dy, d_ssm, gn = _inputs(B=1, nh=4, seed=3)

    def leaves():
        return [a.clone().requires_grad_(True) for a in _torch(
            args, torch.float32)]

    a1 = leaves()
    tsf.ssd_fused_dirs(*a1, d_ssm, gn, impl="torch").backward(
        torch.from_numpy(dy))
    a2 = leaves()
    want = torch.autograd.grad(
        tsf.ssd_fused_dirs_fwd_ref(*a2, d_ssm, gn), a2, torch.from_numpy(dy))
    for nm, x, w in zip(NAMES, a1, want):
        # the dt channels of the stack get no cotangent from the kernel:
        # dt reaches y only through acum/dte/cdec/dtp
        _close(x.grad, w.numpy(), 1e-4, 1e-4, None, nm)


def test_dispatcher_counts_no_launch_on_cpu_and_refuses_cuda():
    args, dy, d_ssm, gn = _inputs(B=1, seed=4)
    ta = _torch(args, torch.float32)
    before = (tsf.ssd_fused_dirs_fwd.launches,
              tsf.ssd_fused_dirs_bwd.launches)
    y = tsf.ssd_fused_dirs(*ta, d_ssm, gn)          # auto -> plain on CPU
    assert y.shape == (1, 4, 16, 16 * 8) and y.grad_fn is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.ssd_fused_dirs(*ta, d_ssm, gn, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsf.ssd_fused_dirs_bwd(*ta, d_ssm, gn, None, torch.from_numpy(dy),
                               impl="cuda")
    with pytest.raises(ValueError, match="unknown SSD impl"):
        tsf.ssd_fused_dirs(*ta, d_ssm, gn, impl="pallas")
    assert (tsf.ssd_fused_dirs_fwd.launches,
            tsf.ssd_fused_dirs_bwd.launches) == before


def _medssd_stage_args(dtype=torch.float32, B=1, nc=2, l=16, nh=2, P=32,
                       gn=8):
    H4, d_ssm = 4 * nh, nh * P
    stack = torch.randn(B, nc, l, 2 * (d_ssm + 2 * gn + nh)).to(dtype)
    rows = lambda: torch.rand(B, nc, H4, l)
    return [stack, rows(), rows(), torch.rand(B, nc, H4), rows(),
            torch.rand(H4)], d_ssm, gn


@pytest.mark.parametrize("fault", ["dtype", "noncontiguous", "channels",
                                   "headdim", "chunk", "state", "state_tile",
                                   "row_dtype",
                                   "row_shape", "dsk", "ssave", "dy"])
def test_kernel_wrapper_refuses_bad_input(fault):
    """The argument checks that run before any launch."""
    args, d_ssm, gn = _medssd_stage_args()
    kw = {}
    if fault == "dtype":
        args[0] = args[0].half()
    elif fault == "noncontiguous":
        args[1] = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "channels":
        args[0] = args[0][..., :-2].contiguous()
    elif fault == "headdim":              # P = 16, not a multiple of 32
        args, d_ssm, gn = _medssd_stage_args(P=16)
    elif fault == "chunk":
        args, d_ssm, gn = _medssd_stage_args(l=260)
    elif fault == "state":
        args, d_ssm, gn = _medssd_stage_args(gn=130)
    elif fault == "state_tile":           # N = 16, not a multiple of 32
        args, d_ssm, gn = _medssd_stage_args(gn=4)
    elif fault == "row_dtype":
        args[2] = args[2].double()
    elif fault == "row_shape":
        args[3] = args[3][:, :1].contiguous()
    elif fault == "dsk":
        args[5] = args[5][None]
    elif fault == "ssave":
        kw["Ssave"] = torch.zeros(1, 2, 8, 32, 4 * gn + 4)   # wrong N
        kw["dy"] = torch.zeros(1, 2, 16, 8 * 32)
    else:                                                   # wrong dtype
        kw["Ssave"] = torch.zeros(1, 2, 8, 32, 4 * gn)
        kw["dy"] = torch.zeros(1, 2, 16, 8 * 32, dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        tsf._check_cuda_args(*args, d_ssm, gn, **kw)


def test_kernel_wrapper_accepts_medssd_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        args, d_ssm, gn = _medssd_stage_args(dtype, l=224, gn=128)
        B, nc, l = args[0].shape[:3]
        tsf._check_cuda_args(
            *args, d_ssm, gn,
            Ssave=torch.zeros(B, nc, 8, 32, 4 * gn, dtype=dtype),
            dy=torch.zeros(B, nc, l, 8 * 32, dtype=dtype))
