"""The two-level (chunk-parallel) decomposition of the port's selective scan.

``scan_folded_fwd_two_level_ref`` and ``scan_folded_bwd_two_level_ref``
restate in plain PyTorch what the CUDA kernels (csrc/selective_scan_fwd.cu,
csrc/selective_scan_bwd.cu) compute: every chunk walked from zero, a carry
pass over the chunks with the decay exp(A sum(dt)), then every chunk walked
again from its true entering value.  They are held against the sequential
twins (``scan_folded_fwd_ref``, ``scan_folded_bwd_ref``) over both
directions, softplus on and off, K 1 and 2, N 8 and 16, the state flags,
and sequence lengths around the chunk (1, under it, equal, one over, and a
ragged multiple), and against the JAX package's
``selective_scan_pallas_folded`` (its v2 kernels in Pallas interpret mode,
forward and ``jax.vjp``).  All in fp32: the point is the decomposition, and
only the order of the rounding differs (the carry pass multiplies by
exp(A sum(dt)) where the sequential walk multiplies the per-step exps), so
the twins agree to 1e-4 relative to each output's largest entry; the JAX
kernel chunks and sums in yet another order, at the 1e-4 / 2e-3 of
tests/test_torch_scan_flags.py.
"""

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

torch.set_num_threads(1)
NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias", "dinit")
CH = fwd.CHUNK
# around the chunk: one step, under it, equal, one over, a ragged multiple
LENGTHS = (1, CH - 3, CH, CH + 1, 4 * CH + 5)
# (K, N): one group at N 8 (the N 8 template), two groups at N 16
GROUPS = ((1, 8), (2, 16))


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    # the JAX dispatcher copies its flag into v2 and bwd2; restore theirs
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)
    monkeypatch.setattr(bwd2, "_INTERPRET", bwd2._INTERPRET)


def _inputs(seed, K, L, N, softplus, Dm=8, batch=2):
    """Folded scan inputs as numpy from ``seed``, with an initial state
    and the two cotangents (dy, dlast).  Without softplus dt = delta + bias
    is kept positive, as a model's would be, so that no step grows the
    state."""
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    delta = 0.5 * f(G, L, Dm)
    bias = 0.1 * f(K, Dm)
    if not softplus:
        delta, bias = np.abs(delta) + 0.05, np.abs(bias)
    inp = dict(u=f(G, L, Dm), delta=delta, A=-np.exp(0.5 * f(K, Dm, N)),
               B=f(G, L, N), C=f(G, L, N), D=f(K, Dm), bias=bias)
    return inp, f(G, N, Dm), f(G, L, Dm), f(G, N, Dm)


def _close(got, want, what):
    scale = float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale,
                               msg=what)


@pytest.mark.parametrize("K,N", GROUPS)
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_two_level_matches_sequential(reverse, softplus, L, K, N):
    """y, xsave and the last state from ``init``, then all eight gradients
    from ``dlast`` (the backward reading the sequential twin's xsave),
    against the sequential twins; with no flags the two-level forward's y
    and xsave are unchanged, and a zero init or dlast gives the flag-free
    results bit for bit (the carry pass starts from 0 either way)."""
    inp, init, dy, dlast = _inputs(L + 10 * K + 2 * reverse + softplus, K,
                                   L, N, softplus)
    args = [torch.from_numpy(inp[k]) for k in NAMES]
    init, dy, dlast = (torch.from_numpy(t) for t in (init, dy, dlast))
    kw = dict(reverse=reverse, softplus=softplus)
    want = fwd.scan_folded_fwd_ref(*args, **kw, want_xsave=True,
                                   want_state=True, init=init)
    got = fwd.scan_folded_fwd_two_level_ref(*args, **kw, want_xsave=True,
                                            want_state=True, init=init)
    assert got[1].shape == (args[0].shape[0], -(-L // CH), N, 8)
    for name, a, b in zip(("y", "xsave", "last"), got, want):
        _close(a, b, name)
    # the first chunk scanned enters with init, exactly
    torch.testing.assert_close(got[1][:, -1 if reverse else 0], init,
                               rtol=0, atol=0)
    y0, x0 = fwd.scan_folded_fwd_two_level_ref(*args, **kw, want_xsave=True)
    yz, xz = fwd.scan_folded_fwd_two_level_ref(*args, **kw, want_xsave=True,
                                               init=torch.zeros_like(init))
    assert torch.equal(y0, yz) and torch.equal(x0, xz)

    xsave = want[1]
    g_want = bwd.scan_folded_bwd_ref(*args, xsave, dy, **kw, dlast=dlast,
                                     want_dinit=True)
    g_got = bwd.scan_folded_bwd_two_level_ref(*args, xsave, dy, **kw,
                                              dlast=dlast, want_dinit=True)
    assert len(g_got) == len(GRADS)
    for name, a, b in zip(GRADS, g_got, g_want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(a, b, name)
    g0 = bwd.scan_folded_bwd_two_level_ref(*args, xsave, dy, **kw)
    gz = bwd.scan_folded_bwd_two_level_ref(*args, xsave, dy, **kw,
                                           dlast=torch.zeros_like(dlast))
    assert all(torch.equal(a, b) for a, b in zip(g0, gz))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [CH + 1, 4 * CH + 5])
def test_two_level_matches_pallas(reverse, L):
    """The two-level twins, forward with init and last and backward with
    dlast and dinit, against ``selective_scan_pallas_folded`` and its
    custom VJP (K 2, N 16, fp32): y and last at 1e-4, the gradients at
    2e-3, as tests/test_torch_scan_flags.py holds the sequential twins."""
    K, N = 2, 16
    inp, init, dy, dlast = _inputs(70 + L + reverse, K, L, N, True)
    jx = [jnp.asarray(inp[k]) for k in NAMES]
    (y_j, last_j), vjp = jax.vjp(
        lambda *a: ssp.selective_scan_pallas_folded(
            *a[:7], reverse=reverse, return_last_state=True,
            initial_state=a[7]), *jx, jnp.asarray(init))
    g_j = vjp((jnp.asarray(dy), jnp.asarray(dlast)))

    args = [torch.from_numpy(inp[k]) for k in NAMES]
    y_t, xsave, last_t = fwd.scan_folded_fwd_two_level_ref(
        *args, reverse=reverse, want_xsave=True, want_state=True,
        init=torch.from_numpy(init))
    fw = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), err_msg="y",
                               **fw)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               err_msg="last", **fw)
    g_t = bwd.scan_folded_bwd_two_level_ref(
        *args, xsave, torch.from_numpy(dy), reverse=reverse,
        dlast=torch.from_numpy(dlast), want_dinit=True)
    for name, gt, gj in zip(GRADS, g_t, g_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


def test_chunked_operands_pad_with_identity_steps():
    """The ragged last chunk is padded with dt = u = B = C = 0, the scan's
    identity step, so a walk over the pad leaves the state as it was."""
    inp, _, _, _ = _inputs(5, 1, CH + 3, 8, True)
    args = [torch.from_numpy(inp[k]) for k in NAMES]
    u, delta, A, B, C, D, bias = args
    op = fwd.chunked_operands(u, delta, A, B, C, bias, True, CH)
    assert op["dt"].shape == (2, 2, CH, 8, 1)
    assert op["B"].shape == op["C"].shape == (2, 2, CH, 1, 8)
    for k in ("dt", "dtu", "B", "C"):
        assert float(op[k][:, 1, 3:].abs().max()) == 0.0, k
    assert float(torch.exp(op["dt"][:, 1, 3:] * op["A"][:, None]).min()) == 1
