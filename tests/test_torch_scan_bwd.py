"""The port's selective-scan backward: the plain backward twin against the
JAX package's Pallas backward (``jax.vjp`` of ``selective_scan_pallas_folded``
in Pallas interpret mode) and against torch.autograd through the plain
forward; the plain forward's saved chunk states; and ``ScanFolded``'s
plumbing with the CUDA launches stood in for by the plain twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_bwd_v2 as bwd2  # noqa: E501
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu_torch.kernels import (
    selective_scan_bwd as bwd,
    selective_scan_fwd as fwd,
)

torch.set_num_threads(2)
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    # the JAX dispatcher copies its flag into v2 and bwd2; restore theirs
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)
    monkeypatch.setattr(bwd2, "_INTERPRET", bwd2._INTERPRET)


def _inputs(seed, batch, K, L, Dm, N):
    """Folded scan inputs and a cotangent, as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(G, L, Dm), delta=0.5 * f(G, L, Dm),
                A=-np.exp(0.5 * f(K, Dm, N)), B=f(G, L, N), C=f(G, L, N),
                D=f(K, Dm), bias=0.1 * f(K, Dm)), f(G, L, Dm)


def _torch_args(inp, dtype=torch.float32):
    act = ("u", "delta", "B", "C")
    return [torch.from_numpy(inp[k]).to(dtype if k in act else torch.float32)
            for k in ("u", "delta", "A", "B", "C", "D", "bias")]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [64, 100])
def test_bwd_ref_matches_pallas_vjp(L, reverse, dtype):
    """All seven gradients against the JAX backward kernel.  L 100 is not a
    multiple of the port's chunk (16) nor of the JAX one.  fp32 at 2e-3
    (the two chunk and order the sums differently); bf16 at the ladder of
    tests/test_pallas_scan.py (6e-2 / 1e-1): du, dΔ, dB, dC are rounded to
    bf16 on both sides."""
    inp, dy = _inputs(L + reverse, 1, 2, L, 32, 16)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    act = ("u", "delta", "B", "C")
    jx = [jnp.asarray(inp[k], jdt if k in act else jnp.float32)
          for k in ("u", "delta", "A", "B", "C", "D", "bias")]
    y_j, vjp = jax.vjp(lambda *a: ssp.selective_scan_pallas_folded(
        *a, reverse=reverse), *jx)
    # JAX order: u, delta, A, B, C, D, bias
    g_j = vjp(jnp.asarray(dy, jdt))

    args = _torch_args(inp, tdt)
    y_t, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                         want_xsave=True)
    assert xsave.shape == (2, -(-L // fwd.CHUNK), 16, 32)
    g_t = bwd.scan_folded_bwd_ref(*args, xsave, torch.from_numpy(dy).to(tdt),
                                  reverse=reverse)
    tol = dict(rtol=6e-2, atol=1e-1) if dtype == "bf16" else \
        dict(rtol=2e-3, atol=2e-3)
    for name, gt, gj, a in zip(GRADS, g_t, g_j, args):
        assert gt.dtype == a.dtype and gt.shape == a.shape, name
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(gj, np.float32), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [20, 64, 70])
def test_bwd_ref_matches_autograd(L, reverse):
    """The explicit formulas against torch.autograd through the sequential
    plain forward, fp32 at 1e-4 (the same fp32 arithmetic, summed in
    another order); L 20 is shorter than one chunk."""
    inp, dy = _inputs(3 * L + reverse, 2, 2, L, 8, 4)
    leaves = [a.requires_grad_(True) for a in _torch_args(inp)]
    y = fwd.scan_folded_fwd_ref(*leaves, reverse=reverse)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    args = [a.detach() for a in leaves]
    y2, xsave = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                        want_xsave=True)
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)
    got = bwd.scan_folded_bwd_ref(*args, xsave, torch.from_numpy(dy),
                                  reverse=reverse)
    for name, g, w in zip(GRADS, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_xsave_holds_each_chunks_incoming_state(reverse):
    """xsave[:, c] is the state entering chunk c in scan order (from the
    right for a reverse scan): zero for the first chunk scanned, and the
    golden model's last state over the chunks scanned before it.  To an
    fp32 ulp or two: the reference runs exp and softplus on tensors cut at
    other places, and torch's vectorised and scalar paths may round apart.
    Another chunk length changes only the order of the backward's sums.
    """
    from medical_image_classification_tpu_torch.kernels.selective_scan import (
        selective_scan_seq)
    L, chunk = 70, 32
    inp, dy = _inputs(11, 1, 1, L, 8, 4)
    u, delta, A, B, C, D, bias = _torch_args(inp)
    _, xsave = fwd.scan_folded_fwd_ref(u, delta, A, B, C, D, bias,
                                       reverse=reverse, want_xsave=True,
                                       chunk=chunk)
    assert xsave.shape == (1, 3, 4, 8)
    for c in range(3):
        # the steps scanned before chunk c, in scan order
        if reverse:
            sl = [torch.flip(t[:, (c + 1) * chunk:], dims=(1,))
                  for t in (u, delta, B, C)]
        else:
            sl = [t[:, :c * chunk] for t in (u, delta, B, C)]
        if sl[0].shape[1] == 0:
            want = torch.zeros(1, 8, 4)
        else:
            _, want = selective_scan_seq(
                sl[0], sl[1], A[0], sl[2], sl[3], D=D[0],
                delta_bias=bias[0], delta_softplus=True,
                return_last_state=True)
        torch.testing.assert_close(xsave[:, c], want.transpose(1, 2),
                                   rtol=1e-5, atol=1e-6)
    args = (u, delta, A, B, C, D, bias)
    dy = torch.from_numpy(dy)
    # the kernels' chunk (fwd.CHUNK, 16) against this one
    g_other = bwd.scan_folded_bwd_ref(*args, xsave, dy, reverse=reverse,
                                      chunk=chunk)
    _, xsave_k = fwd.scan_folded_fwd_ref(*args, reverse=reverse,
                                         want_xsave=True)
    g_k = bwd.scan_folded_bwd_ref(*args, xsave_k, dy, reverse=reverse)
    for name, a, b in zip(GRADS, g_other, g_k):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


def _fake_fwd_kernel(u, delta, A, B, C, D, bias, y, xsave, reverse,
                     softplus, init=None, last=None):
    """Stands in for the CUDA forward launch: fills the wrapper's buffers
    with the plain twin's results."""
    yr, xr, lr = fwd.scan_folded_fwd_ref(u, delta, A, B, C, D, bias,
                                         reverse=reverse, softplus=softplus,
                                         want_xsave=True, want_state=True,
                                         init=init)
    y.copy_(yr)
    for buf, val in ((xsave, xr), (last, lr)):
        if buf is not None:
            buf.copy_(val)


def _fake_bwd_kernel(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta,
                     dB_part, dC_part, dA_part, dD_part, dbias_part, reverse,
                     softplus, dlast=None, dinit=None):
    """Stands in for the CUDA backward launch: writes the plain twin's
    gradients as the kernel's partials (all in the first channel block and
    the first batch entry, zeros elsewhere), so the wrapper's sums must
    give them back."""
    g = bwd.scan_folded_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy,
                                reverse=reverse, softplus=softplus,
                                dlast=dlast, want_dinit=True)
    if dinit is not None:
        dinit.copy_(g[7])
    K = A.shape[0]
    du.copy_(g[0])
    ddelta.copy_(g[1])
    for part, full in ((dB_part, g[3]), (dC_part, g[4])):
        part.zero_()
        part[0] = full
    for t in (dA_part, dD_part, dbias_part):
        t.zero_()
    dA_part[:K] = g[2].transpose(1, 2)
    dD_part[:K] = g[5]
    dbias_part[:K] = g[6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_folded_plumbing(monkeypatch, dtype):
    """ScanFolded with impl="cuda", the two launches stood in for by the
    plain twins: the wrappers' checks, buffers, partial sums and counters
    run as on the card; gradients reach all seven inputs in their dtypes
    and equal the plain ScanFolded's; a non-contiguous cotangent (as the
    column directions give) is accepted."""
    monkeypatch.setattr(fwd, "_fwd_kernel", _fake_fwd_kernel)
    monkeypatch.setattr(bwd, "_bwd_kernel", _fake_bwd_kernel)
    inp, _ = _inputs(5, 2, 2, 40, 64, 8)
    G, L, Dm = inp["u"].shape
    dy = torch.randn(G, Dm, L, generator=torch.Generator().manual_seed(0))
    dy = dy.to(dtype).transpose(1, 2)                  # non-contiguous
    assert not dy.is_contiguous()
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [a.requires_grad_(True) for a in _torch_args(inp, dtype)]
        f0, b0 = fwd.scan_folded_fwd.launches, bwd.scan_folded_bwd.launches
        y = bwd.ScanFolded.apply(*leaves, True, True, impl)
        y.backward(dy)
        launched = (fwd.scan_folded_fwd.launches - f0,
                    bwd.scan_folded_bwd.launches - b0)
        assert launched == ((1, 1) if impl == "cuda" else (0, 0))
        grads[impl] = [a.grad for a in leaves]
        for name, g, a in zip(GRADS, grads[impl], leaves):
            assert g is not None and g.dtype == a.dtype, name
            assert g.shape == a.shape and bool(torch.isfinite(g).all()), name
            assert float(g.float().abs().max()) > 0, name
    for name, gk, gp in zip(GRADS, grads["cuda"], grads["torch"]):
        torch.testing.assert_close(gk, gp, rtol=1e-6, atol=1e-6, msg=name)


def test_dispatcher_tracks_grad_only_under_autograd():
    """scan_folded_fwd goes through ScanFolded exactly when grad is enabled
    and an input requires grad; the eval path builds no graph."""
    inp, dy = _inputs(7, 1, 2, 40, 16, 4)
    args = _torch_args(inp)
    assert fwd.scan_folded_fwd(*args).grad_fn is None
    leaves = [a.requires_grad_(True) for a in args]
    with torch.no_grad():
        assert fwd.scan_folded_fwd(*leaves).grad_fn is None
    with torch.inference_mode():
        assert fwd.scan_folded_fwd(*leaves).grad_fn is None
    y = fwd.scan_folded_fwd(*leaves, reverse=True)
    assert type(y.grad_fn).__name__ == "ScanFoldedBackward"
    # A, D, bias reach the Function through the fp32 casts
    y.backward(torch.from_numpy(dy))
    assert all(a.grad is not None for a in leaves)


@pytest.mark.parametrize("fault", ["xsave_shape", "dy_dtype",
                                   "dy_noncontiguous"])
def test_bwd_wrapper_refuses_bad_input(fault):
    inp, dy = _inputs(9, 1, 2, 40, 32, 4)
    args = _torch_args(inp)
    _, xsave = fwd.scan_folded_fwd_ref(*args, want_xsave=True)
    dy = torch.from_numpy(dy)
    if fault == "xsave_shape":
        xsave = xsave[:, :1].contiguous()
    elif fault == "dy_dtype":
        dy = dy.bfloat16()
    else:
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        bwd._check_bwd_args(*args, xsave, dy)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bwd.scan_folded_bwd(*args, xsave, dy, impl="cuda")
