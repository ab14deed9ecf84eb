"""The KAN helpers no model calls, the port's against the JAX package's on
the same numpy inputs, fp32 on the CPU: ``kan_regularization``,
``okan_forward(return_acts=True)`` and ``OKANLayer``'s ``return_acts``
(the JAX layer's own checks, ``tests/test_kan.py:67-80``, on both, and
every returned tensor against JAX's), ``okan_get_subset``, ``okan_swap``
and ``okan_refine_grid`` (its knots bit for bit, its refit within 1e-4 x
max through the output, and the refined layer keeping the function as
``tests/test_kan.py:103-115`` asks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.ops.kan as jk
import medical_image_classification_tpu_torch.ops.kan as tk
from medical_image_classification_tpu.models import kan_modules as jm
from medical_image_classification_tpu_torch.models import kan_modules as tm

torch.set_num_threads(1)
FWD = 1e-5


def _close(got, want, rel, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _okan_inputs(seed, num=5, k=3, i=4, o=6, batch=10):
    rng = np.random.default_rng(seed)
    g0 = np.broadcast_to(np.asarray(jnp.linspace(-1.0, 1.0, num + 1)),
                         (i, num + 1))
    grid = np.asarray(jk.extend_grid(jnp.asarray(g0), k))
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    mask = np.asarray(jk.sparse_mask(i, o))
    return dict(x=f(batch, i), grid=grid, coef=f(i, o, num + k),
                scale_base=f(i, o), scale_sp=f(i, o), mask=mask, k=k)


@pytest.mark.parametrize("shape", [(6, 4, 8), (3, 5, 4)])
def test_kan_regularization_matches_jax(shape):
    w = (0.3 * np.random.default_rng(0).standard_normal(shape)).astype(
        np.float32)
    for act, ent in ((1.0, 1.0), (0.5, 2.0)):
        got = tk.kan_regularization(_t(w), act, ent)
        want = jk.kan_regularization(jnp.asarray(w), act, ent)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_okan_forward_return_acts_matches_jax():
    """(y, preacts, postacts, postspline) against JAX within 1e-5 x max;
    y also equal to the matmul path's y and to the sum of postacts."""
    a = _okan_inputs(1)
    args = [a[n] for n in ("x", "grid", "coef", "scale_base", "scale_sp",
                           "mask")]
    got = tk.okan_forward(*map(_t, args), a["k"], return_acts=True)
    want = jax.jit(jk.okan_forward, static_argnums=(6, 7))(
        *map(jnp.asarray, args), a["k"], True)
    assert len(got) == len(want) == 4
    for g, w, what in zip(got, want, ("y", "preacts", "postacts",
                                      "postspline")):
        _close(g, w, FWD, what)
    _close(got[0], tk.okan_forward(*map(_t, args), a["k"]).numpy(), FWD,
           "y against the matmul path")
    _close(got[2].sum(-1), got[0].numpy(), FWD, "sum of postacts")


def test_okan_layer_return_acts_matches_jax():
    """The JAX test's layer (out 5, num 5, k 3, x [8, 3]) with its init
    carried into the port: y with and without acts, the acts' shapes and
    values, and y the sum of postacts over the inputs."""
    jmod = jm.OKANLayer(5, num=5, k=3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (8, 3)))
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(6), x)
    apply = jax.jit(jmod.apply, static_argnames=("return_acts",))
    tmod = tm.OKANLayer(3, 5, num=5, k=3)
    sd = {**{n: _t(v) for n, v in variables["params"].items()},
          **{n: _t(v) for n, v in variables["kan_state"].items()}}
    tmod.load_state_dict(sd, strict=True)
    y = tmod(_t(x))
    y2, pre, post, postsp = tmod(_t(x), return_acts=True)
    assert tuple(y.shape) == (8, 5)
    assert tuple(pre.shape) == (8, 5, 3) and tuple(post.shape) == (8, 5, 3)
    np.testing.assert_allclose(y.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(post.sum(-1).detach().numpy(),
                               y.detach().numpy(), rtol=1e-4, atol=1e-5)
    want = apply(variables, x, return_acts=True)
    for g, w, what in zip((y2, pre, post, postsp), want,
                          ("y", "preacts", "postacts", "postspline")):
        _close(g, w, FWD, what)
    _close(y, apply(variables, x), FWD, "y")


def test_okan_get_subset_and_swap_match_jax():
    a = _okan_inputs(2)
    arrs = [a[n] for n in ("grid", "coef", "scale_base", "scale_sp", "mask")]
    in_idx, out_idx = [3, 0, 2], [5, 1]
    got = tk.okan_get_subset(*map(_t, arrs), in_idx, out_idx)
    want = jk.okan_get_subset(*map(jnp.asarray, arrs), in_idx, out_idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i, j, axis in ((0, 3, 0), (1, 4, 1), (2, 2, 0)):
        sub = arrs[1:]                      # coef, scales, mask: [in, out..]
        before = [_t(s) for s in sub]
        got = tk.okan_swap(before, i, j, axis)
        want = jk.okan_swap([jnp.asarray(s) for s in sub], i, j, axis)
        for g, w, b, s in zip(got, want, before, sub):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(b.numpy(), s)   # inputs untouched


@pytest.mark.parametrize("new_num", [10, 7])
def test_okan_refine_grid_matches_jax(new_num):
    """The JAX test's case (k 3, num 5, in 3, out 2, coef 0.3 x normal):
    the new knots equal JAX's bit for bit; the refined layer's output
    within 1e-4 x max of JAX's refined layer (the two ridge solves differ
    in their last bits, and the end coefficients, which few samples
    constrain, carry it: the refit is held through the output, as in
    ``test_torch_kan.py``); where the new knots hold the old ones (10 of
    5, the JAX test's), it keeps the function (5e-3, as the JAX test) on
    32 points; also with explicit samples."""
    k, num, in_dim, out = 3, 5, 3, 2
    g0 = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, num + 1), (in_dim, num + 1))
    grid = np.asarray(jk.extend_grid(g0, k))
    coef = (0.3 * np.random.default_rng(0).standard_normal(
        (in_dim, out, num + k))).astype(np.float32)
    x = np.random.default_rng(1).uniform(-0.9, 0.9, (32, in_dim)).astype(
        np.float32)
    for samples in (None, x):
        kw = {} if samples is None else dict(samples=samples)
        want_grid, want_coef = jax.jit(
            jk.okan_refine_grid, static_argnums=(2, 3))(
            jnp.asarray(grid), jnp.asarray(coef), new_num, k, **kw)
        kw = {} if samples is None else dict(samples=_t(samples))
        new_grid, new_coef = tk.okan_refine_grid(_t(grid), _t(coef),
                                                 new_num, k, **kw)
        np.testing.assert_array_equal(new_grid.numpy(), np.asarray(want_grid))
        _close(tk.coef2curve(_t(x), new_grid, new_coef, k),
               jax.jit(jk.coef2curve, static_argnums=3)(
                   jnp.asarray(x), want_grid, want_coef, k), 1e-4,
               "refined layer")
        if new_num % num == 0:
            y_old = tk.coef2curve(_t(x), _t(grid), _t(coef), k)
            y_new = tk.coef2curve(_t(x), new_grid, new_coef, k)
            np.testing.assert_allclose(y_new.numpy(), y_old.numpy(),
                                       atol=5e-3)
