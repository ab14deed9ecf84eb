"""The selective scan's state flags in the port, against the JAX package.

The plain folded forward with ``want_state`` and ``init`` and the plain
backward with ``dlast`` and ``want_dinit`` against
``selective_scan_pallas_folded`` (its v2 kernels in Pallas interpret mode,
forward and ``jax.vjp``); ``ScanFolded`` with the flags against
torch.autograd through the plain forward, and with the CUDA launches stood
in for by the plain versions; the generic-layout entry against JAX's
``selective_scan_seq``; the chunked plain scan, the decode step and the
dispatcher against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_bwd_v2 as bwd2  # noqa: E501
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu.kernels.selective_scan import (
    selective_scan_seq as jax_scan_seq,
    selective_scan_xla as jax_scan_xla,
    selective_state_update as jax_state_update,
)
from medical_image_classification_tpu_torch.kernels import (
    selective_scan as tss,
    selective_scan_bwd as bwd,
    selective_scan_fwd as fwd,
)
from test_torch_scan_bwd import _fake_bwd_kernel, _fake_fwd_kernel

torch.set_num_threads(1)
NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias", "dinit")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    # the JAX dispatcher copies its flag into v2 and bwd2; restore theirs
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)
    monkeypatch.setattr(bwd2, "_INTERPRET", bwd2._INTERPRET)


def _inputs(seed, batch, K, L, Dm, N):
    """Folded scan inputs, an initial state and the two cotangents (dy,
    dlast), as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = dict(u=f(G, L, Dm), delta=0.5 * f(G, L, Dm),
               A=-np.exp(0.5 * f(K, Dm, N)), B=f(G, L, N), C=f(G, L, N),
               D=f(K, Dm), bias=0.1 * f(K, Dm))
    return inp, f(G, N, Dm), f(G, L, Dm), f(G, N, Dm)


def _torch_args(inp, dtype=torch.float32):
    act = ("u", "delta", "B", "C")
    return [torch.from_numpy(inp[k]).to(dtype if k in act else torch.float32)
            for k in NAMES]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_flags_match_pallas(reverse, dtype):
    """want_state / init forward and dlast / dinit backward against the JAX
    v2 kernels.  L 100 is not a multiple of the port's chunk (32) and pads
    the JAX chunk (104), whose pad rows the flags must skip.  y and last at
    fp32 1e-4, bf16 3e-2 / 5e-2 (y rounds to bf16 on both sides); the fp32
    gradients (dA, dD, dbias, dinit, and all of them for fp32 inputs) at
    2e-3, the summation orders differing; du, dΔ, dB, dC of bf16 inputs at
    the ladder of tests/test_pallas_scan.py (6e-2 / 1e-1), one bf16 step."""
    inp, init, dy, dlast = _inputs(40 + 2 * reverse + (dtype == "bf16"), 1,
                                   2, 100, 32, 8)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    act = ("u", "delta", "B", "C")
    jx = [jnp.asarray(inp[k], jdt if k in act else jnp.float32)
          for k in NAMES]
    (y_j, last_j), vjp = jax.vjp(
        lambda *a: ssp.selective_scan_pallas_folded(
            *a[:7], reverse=reverse, return_last_state=True,
            initial_state=a[7]), *jx, jnp.asarray(init))
    g_j = vjp((jnp.asarray(dy, jdt), jnp.asarray(dlast)))

    args = _torch_args(inp, tdt)
    y_t, xsave, last_t = fwd.scan_folded_fwd_ref(
        *args, reverse=reverse, want_xsave=True, want_state=True,
        init=torch.from_numpy(init))
    assert y_t.dtype == tdt and last_t.dtype == torch.float32
    assert last_t.shape == init.shape
    # the first chunk scanned enters with init
    first = xsave[:, -1] if reverse else xsave[:, 0]
    torch.testing.assert_close(first, torch.from_numpy(init), rtol=0, atol=0)
    fw = dict(rtol=3e-2, atol=5e-2) if dtype == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), err_msg="y", **fw)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               err_msg="last", **fw)

    g_t = bwd.scan_folded_bwd_ref(*args, xsave, torch.from_numpy(dy).to(tdt),
                                  reverse=reverse,
                                  dlast=torch.from_numpy(dlast),
                                  want_dinit=True)
    for name, gt, gj in zip(GRADS, g_t, g_j):
        low = gt.dtype == torch.bfloat16
        tol = dict(rtol=6e-2, atol=1e-1) if low else dict(rtol=2e-3,
                                                          atol=2e-3)
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(gj, np.float32), err_msg=name,
                                   **tol)


def test_flags_off_leave_the_scan_as_it_was():
    """A zero init and an unread last state change nothing: y, xsave and
    the gradients are the flag-free ones, bit for bit; a zero dlast seeds
    nothing."""
    inp, _, dy, _ = _inputs(3, 1, 2, 70, 16, 4)
    args = _torch_args(inp)
    G, _, Dm = args[0].shape
    y0, xs0 = fwd.scan_folded_fwd_ref(*args, want_xsave=True)
    y1, xs1, _ = fwd.scan_folded_fwd_ref(
        *args, want_xsave=True, want_state=True,
        init=torch.zeros(G, 4, Dm))
    assert torch.equal(y0, y1) and torch.equal(xs0, xs1)
    dy = torch.from_numpy(dy)
    g0 = bwd.scan_folded_bwd_ref(*args, xs0, dy)
    g1 = bwd.scan_folded_bwd_ref(*args, xs0, dy, dlast=torch.zeros(G, 4, Dm),
                                 want_dinit=True)
    assert len(g1) == 8
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_folded_flags_match_autograd(reverse):
    """ScanFolded (plain forward, plain backward) with want_state and init:
    all eight gradients against torch.autograd through the sequential
    plain forward, fp32 at 1e-4; L 45 is a chunk and a ragged part."""
    inp, init, dy, dlast = _inputs(7 + reverse, 2, 2, 45, 8, 4)
    weights = (torch.from_numpy(dy), torch.from_numpy(dlast))

    def grads(fn):
        leaves = [a.requires_grad_(True) for a in _torch_args(inp)]
        i0 = torch.from_numpy(init).requires_grad_(True)
        y, last = fn(leaves, i0)
        loss = (y * weights[0]).sum() + (last * weights[1]).sum()
        return torch.autograd.grad(loss, leaves + [i0])

    got = grads(lambda a, i0: fwd.scan_folded_fwd(
        *a, reverse=reverse, want_state=True, init=i0))
    want = grads(lambda a, i0: fwd.scan_folded_fwd_ref(
        *a, reverse=reverse, want_state=True, init=i0))
    for name, g, w in zip(GRADS, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


def _fake_launches(monkeypatch):
    """The wrappers take the CUDA route on CPU tensors, with the kernels
    stood in for by the plain versions: checks, buffers, partial sums and
    the counters run as on the card."""
    monkeypatch.setattr(fwd, "_fwd_kernel", _fake_fwd_kernel)
    monkeypatch.setattr(bwd, "_bwd_kernel", _fake_bwd_kernel)
    monkeypatch.setattr(fwd, "resolve_impl", lambda impl, t, what: "cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_folded_flags_plumbing(monkeypatch, dtype):
    """ScanFolded on the CUDA route with the flags: one forward and one
    backward launch; gradients reach the seven inputs and init in their
    dtypes and equal the plain route's; the wrappers take init and dlast
    only as [G, N, Dm] fp32."""
    inp, init, dy, dlast = _inputs(9, 2, 2, 40, 64, 8)
    got = {}
    for route in ("torch", "cuda"):
        if route == "cuda":
            _fake_launches(monkeypatch)
        leaves = [a.requires_grad_(True) for a in _torch_args(inp, dtype)]
        i0 = torch.from_numpy(init).requires_grad_(True)
        f0, b0 = fwd.scan_folded_fwd.launches, bwd.scan_folded_bwd.launches
        y, last = fwd.scan_folded_fwd(*leaves, reverse=True, want_state=True,
                                      init=i0)
        assert y.dtype == dtype and last.dtype == torch.float32
        ((y.float() * torch.from_numpy(dy)).sum()
         + (last * torch.from_numpy(dlast)).sum()).backward()
        launched = (fwd.scan_folded_fwd.launches - f0,
                    bwd.scan_folded_bwd.launches - b0)
        assert launched == ((1, 1) if route == "cuda" else (0, 0))
        got[route] = [y, last] + [a.grad for a in leaves + [i0]]
    for name, k, p in zip(("y", "last") + GRADS, got["cuda"], got["torch"]):
        assert k.dtype == p.dtype and bool(torch.isfinite(k.float()).all())
        torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-6, msg=name)
    args = _torch_args(inp)
    for bad in (torch.from_numpy(init).double(),
                torch.from_numpy(init)[:, :4].contiguous(),
                torch.from_numpy(init).transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises((TypeError, ValueError)):
            fwd._launch_cuda(*args, False, True, init=bad)
        _, xsave = fwd.scan_folded_fwd_ref(*args, want_xsave=True)
        with pytest.raises((TypeError, ValueError)):
            bwd._launch_cuda(*args, xsave, torch.from_numpy(dy), False, True,
                             dlast=bad)


def _generic_inputs(seed, batch, L, K, Dm, N, grouped):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    bc = (batch, L, K, N) if grouped else (batch, L, N)
    return dict(u=f(batch, L, K * Dm), delta=0.5 * f(batch, L, K * Dm),
                A=-np.exp(0.5 * f(K * Dm, N)), B=f(*bc), C=f(*bc),
                D=f(K * Dm), z=f(batch, L, K * Dm),
                delta_bias=0.1 * f(K * Dm),
                initial_state=f(batch, K * Dm, N))


@pytest.mark.parametrize("grouped,use_init", [(False, False), (True, True)])
def test_generic_entry_matches_jax_seq(grouped, use_init):
    """selective_scan_generic (the port of selective_scan_pallas) against
    JAX's selective_scan_seq: 3-D B/C (K 1) and grouped 4-D B/C (K 2), the
    z-gate, the initial state and the last state in the generic [batch,
    K * Dm, N] layout, fp32 at 1e-4."""
    inp = _generic_inputs(11 + grouped, 2, 37, 2 if grouped else 1, 16, 4,
                          grouped)
    if not use_init:
        inp.pop("initial_state")
    jx = {k: jnp.asarray(v) for k, v in inp.items()}
    y_j, last_j = jax_scan_seq(
        jx["u"], jx["delta"], jx["A"], jx["B"], jx["C"], D=jx["D"],
        z=jx["z"], delta_bias=jx["delta_bias"], delta_softplus=True,
        return_last_state=True, initial_state=jx.get("initial_state"))
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    y_t, last_t = fwd.selective_scan_generic(
        tt["u"], tt["delta"], tt["A"], tt["B"], tt["C"], D=tt["D"], z=tt["z"],
        delta_bias=tt["delta_bias"], delta_softplus=True,
        return_last_state=True, initial_state=tt.get("initial_state"))
    assert last_t.shape == (2, inp["u"].shape[2], 4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("grouped", [False, True])
def test_chunked_scan_matches_jax_xla(grouped):
    """selective_scan_chunked against JAX's selective_scan_xla: L 45 over
    chunks of 16 (a ragged last chunk), D, z, initial and last state, fp32
    at 1e-4."""
    inp = _generic_inputs(21 + grouped, 2, 45, 2 if grouped else 1, 8, 4,
                          grouped)
    jx = {k: jnp.asarray(v) for k, v in inp.items()}
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    y_j, last_j = jax_scan_xla(
        jx["u"], jx["delta"], jx["A"], jx["B"], jx["C"], D=jx["D"],
        z=jx["z"], delta_bias=jx["delta_bias"], delta_softplus=True,
        return_last_state=True, chunk=16,
        initial_state=jx["initial_state"])
    y_t, last_t = tss.selective_scan_chunked(
        tt["u"], tt["delta"], tt["A"], tt["B"], tt["C"], D=tt["D"], z=tt["z"],
        delta_bias=tt["delta_bias"], delta_softplus=True,
        return_last_state=True, chunk=16,
        initial_state=tt["initial_state"])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), rtol=1e-4,
                               atol=1e-4)


def test_state_update_matches_jax():
    """selective_state_update against JAX's: the new state and y, with the
    Δ bias, softplus, D and z, fp32 at 1e-5."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, d, n = 3, 16, 4
    args = dict(state=f(b, d, n), x=f(b, d), dt=f(b, d),
                A=-np.exp(f(d, n)), B=f(b, n), C=f(b, n), D=f(d), z=f(b, d),
                dt_bias=f(d))
    s_j, y_j = jax_state_update(
        **{k: jnp.asarray(v) for k, v in args.items()}, dt_softplus=True)
    s_t, y_t = tss.selective_state_update(
        **{k: torch.from_numpy(v) for k, v in args.items()},
        dt_softplus=True)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)


def test_dispatcher_routes_and_refusals():
    """selective_scan: "auto", "torch", "seq" and "chunked" agree on the
    CPU (fp32 at 1e-4) and launch nothing; "cuda" and its JAX name
    "pallas" refuse CPU tensors; an unknown impl raises."""
    inp = _generic_inputs(31, 2, 30, 1, 8, 4, False)
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    args = (tt["u"], tt["delta"], tt["A"], tt["B"], tt["C"])
    kw = dict(D=tt["D"], z=tt["z"], delta_bias=tt["delta_bias"],
              delta_softplus=True, return_last_state=True)
    before = fwd.scan_folded_fwd.launches
    outs = {impl: tss.selective_scan(*args, **kw, impl=impl)
            for impl in ("auto", "torch", "seq", "chunked")}
    assert fwd.scan_folded_fwd.launches == before
    for impl, (y, last) in outs.items():
        torch.testing.assert_close(y, outs["seq"][0], rtol=1e-4, atol=1e-4,
                                   msg=impl)
        torch.testing.assert_close(last, outs["seq"][1], rtol=1e-4,
                                   atol=1e-4, msg=impl)
    for impl in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tss.selective_scan(*args, **kw, impl=impl)
    with pytest.raises(ValueError, match="unknown selective_scan impl"):
        tss.selective_scan(*args, **kw, impl="xla")
