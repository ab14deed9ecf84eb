"""The v1 selective scan in the port (doubling scan inside chunks of T),
against the JAX package.

The plain v1 forward and backward against ``_fwd_folded`` and
``bwd_folded`` (Pallas interpret mode, as tests/test_pallas_scan.py runs
them); the folded entry with the chunk cap lowered to 50 on both sides,
through the JAX custom VJP and the port's ``ScanFolded``; the tile chooser
and the v1/v2 choice against the JAX package's over a grid; every shape the
port's models reach at the CLIs' sizes kept on the two-level kernels at the
default cap; the refusals of the flags under v1 and the generic entry's
staying off it."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_bwd as sspb  # noqa: E501
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu_torch.kernels import (
    selective_scan_fwd as fwd,
    selective_scan_v1 as v1,
)

torch.set_num_threads(1)
NAMES = ("u", "delta", "A", "B", "C", "D", "bias")
GRADS = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    monkeypatch.setattr(sspb, "_INTERPRET", True)
    # the JAX dispatcher copies its flag into v2; restore its own
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)


def _inputs(seed, batch, K, L, Dm, N):
    """Folded scan inputs and a cotangent dy, as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = dict(u=f(G, L, Dm), delta=0.5 * f(G, L, Dm),
               A=-np.exp(0.5 * f(K, Dm, N)), B=f(G, L, N), C=f(G, L, N),
               D=f(K, Dm), bias=0.1 * f(K, Dm))
    return inp, f(G, L, Dm)


def _torch(inp):
    return [torch.from_numpy(inp[k]) for k in NAMES]


def _jax(inp):
    return [jnp.asarray(inp[k]) for k in NAMES]


# (L, T, Dm, N): T 50 divides L 100 and pads L 196; T 30 and 33 pad
CASES = [(100, 50, 32, 4), (100, 30, 64, 8), (196, 50, 64, 8),
         (196, 33, 32, 4)]


@pytest.mark.parametrize("L,T,Dm,N", CASES)
def test_plain_fwd_matches_pallas_v1(L, T, Dm, N):
    """y and xsave (the state entering each chunk, [G, ceil(L / T), N, Dm])
    of the plain v1 forward against ``_fwd_folded`` at 1e-4 (the
    tolerance of tests/test_pallas_scan.py:44)."""
    inp, _ = _inputs(L + T, 2, 2, L, Dm, N)
    y_j, x_j = ssp._fwd_folded(*_jax(inp), T, Dm)
    y_t, x_t = v1.scan_v1_fwd_ref(*_torch(inp), T)
    assert tuple(x_t.shape) == (4, -(-L // T), N, Dm) == x_j.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-4)
    # the eval path returns y alone, the same values
    torch.testing.assert_close(
        v1.scan_v1_fwd(*_torch(inp), T), y_t, rtol=0, atol=0)


@pytest.mark.parametrize("L,T,Dm,N", CASES[1:3])
def test_plain_bwd_matches_pallas_v1(L, T, Dm, N):
    """All seven gradients of the plain v1 backward against ``bwd_folded``
    at 2e-3 (tests/test_pallas_scan.py:107), each fp32 and in its input's
    shape; dA, dD and dbias summed over the batch."""
    inp, dy = _inputs(7 + L, 2, 2, L, Dm, N)
    _, x_j = ssp._fwd_folded(*_jax(inp), T, Dm)
    g_j = sspb.bwd_folded(*_jax(inp), x_j, jnp.asarray(dy), T, Dm)
    _, x_t = v1.scan_v1_fwd_ref(*_torch(inp), T)
    g_t = v1.scan_v1_bwd(*_torch(inp), x_t, torch.from_numpy(dy), T)
    for name, gt, gj, p in zip(GRADS, g_t, g_j, _torch(inp)):
        assert gt.dtype == torch.float32 and gt.shape == p.shape, name
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


def test_folded_entry_at_t_cap_50_matches_jax(monkeypatch):
    """``_T_CAP`` 50 on both sides: the JAX folded entry (its custom VJP
    over the v1 kernels) and the port's ``scan_folded_fwd`` (``ScanFolded``
    over the plain v1 pair) give y and the gradients of sum(sin(y)) for
    all seven inputs within 2e-3; the port ran the v1 pair once each."""
    monkeypatch.setattr(ssp, "_T_CAP", 50)
    monkeypatch.setattr(v1, "_T_CAP", 50)
    L, Dm, N = 100, 64, 8
    assert v1.v1_chunk(L, Dm, N) == 50
    inp, _ = _inputs(3, 2, 2, L, Dm, N)
    calls = {"fwd": 0, "bwd": 0}

    def spy(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(v1, "scan_v1_fwd_ref", spy("fwd", v1.scan_v1_fwd_ref))
    monkeypatch.setattr(v1, "scan_v1_bwd_ref", spy("bwd", v1.scan_v1_bwd_ref))

    g_j = jax.grad(
        lambda a: jnp.sum(jnp.sin(ssp.selective_scan_pallas_folded(*a))))(
        _jax(inp))
    y_j = ssp.selective_scan_pallas_folded(*_jax(inp))
    leaves = [t.requires_grad_(True) for t in _torch(inp)]
    y_t = fwd.scan_folded_fwd(*leaves)
    torch.sin(y_t).sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=2e-3, atol=2e-3)
    for name, leaf, gj in zip(GRADS, leaves, g_j):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gj),
                                   rtol=2e-3, atol=2e-3, err_msg=name)


def _jax_kernel(T, Dt):
    """Which kernel ``_fwd_dispatch`` launches at chunk T: its two
    launchers replaced by stubs that name themselves."""
    dummy = jnp.zeros((1, 1, 1))
    return ssp._fwd_dispatch(dummy, dummy, dummy, dummy, dummy, dummy, dummy,
                             T, Dt)


def test_tile_chooser_and_v1_choice_match_jax(monkeypatch):
    """``_choose_tiles`` and the v1/v2 choice equal the JAX package's over
    a grid of (L, Dm, N, _T_CAP, _VMEM_BUDGET), None included (Dm > 512
    with no divisor tile)."""
    monkeypatch.setattr(v2, "fwd_folded_v2", lambda *a, **k: "v2")
    monkeypatch.setattr(ssp, "_fwd_folded", lambda *a, **k: "v1")
    seen = {"v1": 0, "v2": 0, None: 0}
    for cap, budget in itertools.product(
            (224, 100, 50, 33, 8, 1, 1000),
            (int(8.5 * 1024 * 1024), 1 << 20, 64 << 20)):
        monkeypatch.setattr(ssp, "_T_CAP", cap)
        monkeypatch.setattr(v1, "_T_CAP", cap)
        monkeypatch.setattr(ssp, "_VMEM_BUDGET", budget)
        monkeypatch.setattr(v1, "_VMEM_BUDGET", budget)
        for L, Dm, N in itertools.product(
                (1, 7, 49, 50, 100, 196, 784, 3136, 5000),
                (32, 96, 192, 384, 600, 768, 1536), (4, 16, 64)):
            want = ssp._choose_tiles(L, Dm, N)
            assert v1._choose_tiles(L, Dm, N) == want, (L, Dm, N, cap)
            T = v1.v1_chunk(L, Dm, N)
            kernel = None if want is None else _jax_kernel(*want)
            assert (T is not None) == (kernel == "v1"), (L, Dm, N, cap)
            if T is not None:
                assert T == want[0]
            seen[kernel] += 1
    assert all(seen.values()), seen


def _sides(size):
    """Tokens per side at each stage: the patch embed divides by 4, each
    patch merge halves."""
    s = [size // 4]
    for _ in range(3):
        s.append(s[-1] // 2)
    return s


def test_default_cap_keeps_every_model_path_on_v2():
    """At the default cap every scan shape the port's models reach chooses
    the two-level kernels: each registry name's SS2D blocks (the Mamba-1
    scan; the SSD family has none) at the CLIs' image sizes, and the
    Mamba LM's layer call at the published widths for any length up to
    4096.  This guards every model path against the v1 branch."""
    from medical_image_classification_tpu_torch.models import create_model
    from medical_image_classification_tpu_torch.models.registry import (
        available_models)
    from medical_image_classification_tpu_torch.models.ss2d_modules import (
        SS2D)
    assert v1._T_CAP == 224
    scans = set()
    for name in available_models():
        with torch.device("meta"):
            model = create_model(name, 8)
        blocks = [m for m in model.modules() if isinstance(m, SS2D)]
        widths = sorted({(m.d_inner, m.d_state) for m in blocks})
        if not name.startswith("medmamba"):     # the SSD family
            assert not widths, name
        for size in (224, 240, 256, 384, 512):
            for side, (Dm, N) in zip(_sides(size), widths):
                scans.add((side * side, Dm, N))
    assert (3136, 96, 16) in scans and (49, 768, 16) in scans
    for d_model in (768, 1024, 1536, 2048, 2560):
        scans.update((L, 2 * d_model, 16) for L in range(1, 4097))
    for L, Dm, N in scans:
        assert v1.v1_chunk(L, Dm, N) is None, (L, Dm, N)


def test_v1_refuses_the_flags_and_the_generic_entry_stays_off(monkeypatch):
    """Under v1 ``reverse``, ``want_state``, ``init`` and softplus off
    raise ValueError (the JAX dispatch asserts); the generic-layout entry
    never takes v1 (the JAX generic entry is gated on T % 8 == 0)."""
    monkeypatch.setattr(v1, "_T_CAP", 50)
    inp, _ = _inputs(5, 1, 2, 100, 32, 4)
    args = _torch(inp)
    for kw in (dict(reverse=True), dict(want_state=True),
               dict(init=torch.zeros(2, 4, 32)), dict(softplus=False)):
        with pytest.raises(ValueError):
            fwd.scan_folded_fwd(*args, **kw)
        with pytest.raises(ValueError):
            fwd.scan_folded_fwd(*[a.clone().requires_grad_(True)
                                  for a in args], **kw)
    monkeypatch.setattr(v1, "scan_v1_fwd_ref", None)   # any call fails
    u = torch.from_numpy(inp["u"]).reshape(1, 2, 100, 32).transpose(1, 2)
    y = fwd.selective_scan_generic(
        u.reshape(1, 100, 64), 0.5 * u.reshape(1, 100, 64),
        torch.from_numpy(inp["A"]).reshape(64, 4),
        torch.from_numpy(inp["B"][:1]), torch.from_numpy(inp["C"][:1]),
        delta_softplus=True)
    assert y.shape == (1, 100, 64) and bool(torch.isfinite(y).all())


def test_v1_wrappers_check_before_launching():
    """The CUDA route refuses CPU tensors, and the wrappers' checks raise
    before any launch: a wrong xsave shape, a chunk below 1, and every
    size the C entries refuse below 1 (G, L, Dm, K, N).  No chunk is too
    long: the backward keeps its checkpoints outside shared memory, and
    its block's shared memory is bounded at compile time."""
    inp, dy = _inputs(6, 1, 2, 40, 16, 8)
    args = _torch(inp)
    with pytest.raises(ValueError):
        v1.scan_v1_fwd(*args, 20, impl="cuda")
    _, xs = v1.scan_v1_fwd_ref(*args, 20)
    with pytest.raises(ValueError):
        v1._launch_bwd_cuda(*args, xs[:, :1].contiguous(),
                            torch.from_numpy(dy), 20)
    with pytest.raises(ValueError):
        v1._launch_fwd_cuda(*args, 0, False)
    u, delta, A, B, C, D, bias = args
    dyt = torch.from_numpy(dy)
    for name, bad in (
            ("G", (u[:0], delta[:0], A, B[:0], C[:0], D, bias)),
            ("L", (u[:, :0], delta[:, :0], A, B[:, :0], C[:, :0], D, bias)),
            ("Dm", (u[..., :0], delta[..., :0], A[:, :0], B, C, D[:, :0],
                    bias[:, :0])),
            ("K", (u, delta, A[:0], B, C, D[:0], bias[:0])),
            ("N", (u, delta, A[..., :0], B[..., :0], C[..., :0], D, bias))):
        bad = [t.contiguous() for t in bad]
        with pytest.raises(ValueError, match=f"{name}=0"):
            v1._launch_fwd_cuda(*bad, 20, True)
        with pytest.raises(ValueError, match=f"{name}=0"):
            v1._launch_bwd_cuda(*bad, xs, dyt, 20)
    assert v1.scan_v1_fwd.launches == 0 and v1.scan_v1_bwd.launches == 0
