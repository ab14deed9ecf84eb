"""The port's selective-scan golden model and plain folded forward against
the JAX package: ``selective_scan_seq`` against JAX's, and
``scan_folded_fwd_ref`` against ``selective_scan_pallas_folded`` run in
Pallas interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.selective_scan_pallas as ssp
import medical_image_classification_tpu.kernels.selective_scan_pallas_v2 as v2
from medical_image_classification_tpu.kernels.selective_scan import (
    selective_scan_seq as jax_selective_scan_seq,
)
from medical_image_classification_tpu_torch.kernels.selective_scan import (
    selective_scan_seq,
)
from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
    scan_folded_fwd_ref,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ssp, "_INTERPRET", True)
    # the JAX dispatcher copies its flag into v2; restore v2's afterwards
    monkeypatch.setattr(v2, "_INTERPRET", v2._INTERPRET)


def _folded_inputs(seed, batch, K, L, Dm, N):
    rng = np.random.default_rng(seed)
    G = batch * K
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(G, L, Dm), delta=0.5 * f(G, L, Dm),
                A=-np.exp(0.5 * f(K, Dm, N)), B=f(G, L, N), C=f(G, L, N),
                D=f(K, Dm), bias=0.1 * f(K, Dm))


def _run_both(inp, reverse, dtype):
    """JAX Pallas (interpret) and the port's plain version on the same
    inputs; u/delta/B/C in ``dtype``, parameters fp32."""
    act = ("u", "delta", "B", "C")
    jx = {k: jnp.asarray(v, jnp.bfloat16 if dtype == "bf16" and k in act
                         else jnp.float32) for k, v in inp.items()}
    tt = {k: torch.from_numpy(v).to(torch.bfloat16 if dtype == "bf16"
                                    and k in act else torch.float32)
          for k, v in inp.items()}
    y_j = ssp.selective_scan_pallas_folded(
        jx["u"], jx["delta"], jx["A"], jx["B"], jx["C"], jx["D"], jx["bias"],
        reverse=reverse)
    y_t = scan_folded_fwd_ref(tt["u"], tt["delta"], tt["A"], tt["B"],
                              tt["C"], tt["D"], tt["bias"], reverse=reverse)
    return np.asarray(y_j, np.float32), y_t


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("Dm", [96, 32])
@pytest.mark.parametrize("L", [64, 100])
def test_folded_ref_matches_pallas_fp32(L, Dm, reverse):
    inp = _folded_inputs(L + Dm + reverse, 1, 2, L, Dm, 16)
    y_j, y_t = _run_both(inp, reverse, "fp32")
    assert y_t.dtype == torch.float32 and y_t.shape == (2, L, Dm)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [64, 100])
def test_folded_ref_matches_pallas_bf16(L, reverse):
    inp = _folded_inputs(7 * L + reverse, 1, 2, L, 32, 16)
    y_j, y_t = _run_both(inp, reverse, "bf16")
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=3e-2,
                               atol=5e-2)


def test_dispatcher_takes_plain_version_on_cpu():
    inp = _folded_inputs(3, 2, 2, 40, 32, 8)
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    before = scan_folded_fwd.launches
    args = (tt["u"], tt["delta"], tt["A"], tt["B"], tt["C"], tt["D"],
            tt["bias"])
    for reverse in (False, True):
        y = scan_folded_fwd(*args, reverse=reverse)
        torch.testing.assert_close(
            y, scan_folded_fwd_ref(*args, reverse=reverse), rtol=0, atol=0)
    assert scan_folded_fwd.launches == before      # no kernel launched


@pytest.mark.parametrize("groups", [0, 1, 4])
def test_selective_scan_seq_matches_jax(groups):
    """All flags: D, z, delta_bias, softplus, last state, initial state;
    B/C as [B, L, N] (groups=0) or grouped [B, L, G, N]."""
    rng = np.random.default_rng(groups)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    batch, L, d, n = 2, 37, 16, 4
    bc = (batch, L, n) if groups == 0 else (batch, L, groups, n)
    inp = dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
               A=-np.exp(0.5 * f(d, n)), B=f(*bc), C=f(*bc), D=f(d),
               z=f(batch, L, d), delta_bias=0.1 * f(d),
               initial_state=f(batch, d, n))
    kw = dict(delta_softplus=True, return_last_state=True)
    y_j, last_j = jax_selective_scan_seq(
        **{k: jnp.asarray(v) for k, v in inp.items()}, **kw)
    y_t, last_t = selective_scan_seq(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, **kw)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-4, atol=1e-4)
