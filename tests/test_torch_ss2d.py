"""The port's SS2D core (flip-free, four single-direction scans) against
the JAX package: its flip-free path, forced on in Pallas interpret mode,
and its generic XLA cross-scan path, forward and gradients.  Tolerance
2e-3: the folded Weff projection regroups the Δ sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_bwd_v2 as bwd2  # noqa: E501
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu.ops.ss2d import (
    ss2d_core_mamba1 as jax_ss2d_core_mamba1,
)
from medical_image_classification_tpu_torch.ops.ss2d import ss2d_core_mamba1

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def flipfree_interpret(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)
    monkeypatch.setattr(bwd2, "_INTERPRET", bwd2._INTERPRET)
    monkeypatch.setattr(
        ssp, "pallas_folded_supported",
        lambda L, Dm, N: ssp._choose_tiles(L, Dm, N) is not None)


def _inputs(seed, Bb, H, W, D, N, q):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(Bb, H, W, D), 0.3 * f(4, q + 2 * N, D), 0.3 * f(4, D, q),
            0.1 * f(4, D), 0.5 * f(4, D, N), f(4, D))


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("H,W", [(8, 8), (6, 10)])
def test_ss2d_core_matches_jax(H, W, jax_impl):
    N, q = 8, 4
    args = _inputs(H * W, 2, H, W, 32, N, q)
    kw = dict(d_state=N, dt_rank=q)
    y_j = jax_ss2d_core_mamba1(*(jnp.asarray(a) for a in args),
                               impl=jax_impl, **kw)
    y_t = ss2d_core_mamba1(*(torch.from_numpy(a) for a in args), **kw)
    assert tuple(y_t.shape) == (2, H, W, 32) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-3,
                               atol=2e-3)


def test_ss2d_core_bf16_keeps_dtype():
    """bf16 activations stay bf16 through the projections and scans, and
    agree with the fp32 run to bf16 precision."""
    N, q = 8, 4
    args = [torch.from_numpy(a) for a in _inputs(5, 2, 6, 6, 32, N, q)]
    y32 = ss2d_core_mamba1(*args, d_state=N, dt_rank=q)
    y16 = ss2d_core_mamba1(args[0].to(torch.bfloat16), *args[1:],
                           d_state=N, dt_rank=q)
    assert y16.dtype == torch.bfloat16
    scale = float(y32.abs().max())
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=5e-2,
                               atol=5e-2 * scale)


@pytest.mark.parametrize("H,W", [(8, 8), (6, 10)])
def test_ss2d_core_grads_match_jax(H, W):
    """Gradients w.r.t. the input and every parameter of the core against
    jax.grad through the JAX flip-free path (its Pallas backward in
    interpret mode): x_proj_weight and dt_projs_weight reach the scans only
    through Weff and the B/C columns, and the column directions' cotangent
    arrives transposed.  2e-3 relative to each gradient's largest entry."""
    N, q = 8, 4
    args = _inputs(H * W + 1, 2, H, W, 32, N, q)
    w = np.random.default_rng(7).standard_normal((2, H, W, 32)).astype(
        np.float32)
    kw = dict(d_state=N, dt_rank=q)
    g_j = jax.grad(lambda *a: jnp.sum(jax_ss2d_core_mamba1(
        *a, impl="pallas", **kw) * w), argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (ss2d_core_mamba1(*leaves, **kw) * torch.from_numpy(w)).sum().backward()
    names = ("x", "x_proj_w", "dt_proj_w", "dt_proj_b", "A_log", "Ds")
    for name, leaf, gj in zip(names, leaves, g_j):
        gj = np.asarray(gj)
        assert leaf.grad is not None and float(leaf.grad.abs().max()) > 0
        np.testing.assert_allclose(leaf.grad.numpy(), gj, rtol=2e-3,
                                   atol=2e-3 * np.abs(gj).max(),
                                   err_msg=name)
