"""The port's KAN core and layers against the JAX package's, fp32 on the
CPU, inputs from a numpy seed: every ``ops/kan.py`` function; the sample
indices of both re-gridding functions equal JAX's for every batch size
from 2 to 4096; the re-gridded knots within 1e-6 x span and the refit
layer's output within 1e-4 x max|y| (the two ridge solves differ in their
last bits, so the refit is held through the output); ``KANLinear``,
``OKANLayer``, ``KansModule``, ``ThreeKansModule`` and every
``ClassifierHead`` kind with JAX's weights, forward within 1e-5 x max and
the input and parameter gradients within 1e-4 x max, in train and eval
mode (the BatchNorm running stats too); the layers' update_grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.ops.kan as jk_eager
import medical_image_classification_tpu_torch.ops.kan as tk
from medical_image_classification_tpu.models import kan_modules as jm
from medical_image_classification_tpu_torch.models import kan_modules as tm

torch.set_num_threads(2)
FWD, GRAD = 1e-5, 1e-4


class _Jitted:
    """The JAX KAN functions, each under ``jax.jit`` with its int
    arguments static (one compile in place of one per primitive)."""

    def __getattr__(self, name):
        import inspect
        fn = getattr(jk_eager, name)
        static = [n for n, p in inspect.signature(fn).parameters.items()
                  if p.annotation in ("int", int)]
        return jax.jit(fn, static_argnames=static)


jk = _Jitted()


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _x(rng, *shape, scale=0.6):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --- the functional core -----------------------------------------------------

@pytest.mark.parametrize("gs,k", [(5, 1), (5, 3), (7, 5)])
def test_grid_and_bases_match_jax(gs, k):
    rng = np.random.default_rng(gs + k)
    grid_j = jk.make_grid(6, gs, k)
    grid_t = tk.make_grid(6, gs, k)
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(grid_j))
    core = jnp.asarray(np.sort(rng.random((6, gs + 1)), axis=1)
                       .astype(np.float32))
    _close(tk.extend_grid(_t(core), k), jk.extend_grid(core, k), FWD,
           "extend_grid")
    x = _x(rng, 20, 6, scale=1.2)
    _close(tk.b_splines(_t(x), grid_t, k), jk.b_splines(x, grid_j, k), FWD,
           "b_splines")


def test_curve2coeff_and_kan_linear_match_jax():
    rng = np.random.default_rng(1)
    gs, k, i, o = 5, 3, 7, 4
    grid = jk.make_grid(i, gs, k)
    x, y = _x(rng, 40, i), _x(rng, 40, i, o)
    _close(tk.curve2coeff(_t(x), _t(y), _t(grid), k),
           jk.curve2coeff(x, y, grid, k), FWD, "curve2coeff")
    bw, sw, sc = _x(rng, o, i), _x(rng, o, i, gs + k), _x(rng, o, i)
    for scaler in (sc, None):
        xs = _x(rng, 3, 5, i)
        got = tk.kan_linear(_t(xs), _t(grid), _t(bw), _t(sw),
                            None if scaler is None else _t(scaler), k)
        _close(got, jk.kan_linear(xs, grid, bw, sw, scaler, k), FWD,
               "kan_linear")
    # bf16 in, fp32 inside, bf16 out (as the JAX function casts)
    xb = torch.from_numpy(xs).bfloat16()
    assert tk.kan_linear(xb, _t(grid), _t(bw), _t(sw), _t(sc),
                         k).dtype == torch.bfloat16


def test_okan_core_matches_jax():
    rng = np.random.default_rng(2)
    num, k, i, o = 5, 3, 6, 5
    g0 = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, num + 1), (i, num + 1))
    grid = jk.extend_grid(g0, k)
    np.testing.assert_array_equal(
        tk.extend_grid(tk._linspace_f32(-1.0, 1.0, num + 1).expand(i, -1),
                       k).numpy(), np.asarray(grid))
    x, coef = _x(rng, 30, i), _x(rng, i, o, num + k)
    _close(tk.coef2curve(_t(x), _t(grid), _t(coef), k),
           jk.coef2curve(x, grid, coef, k), FWD, "coef2curve")
    y = _x(rng, 30, i, o)
    _close(tk.okan_curve2coef(_t(x), _t(y), _t(grid), k),
           jk.okan_curve2coef(x, y, grid, k), FWD, "okan_curve2coef")
    for a, b in ((7, 3), (3, 7), (8, 8), (1, 5)):
        np.testing.assert_array_equal(tk.sparse_mask(a, b).numpy(),
                                      np.asarray(jk.sparse_mask(a, b)))
    sb, ssp = _x(rng, i, o), _x(rng, i, o)
    mask = np.asarray(jk.sparse_mask(i, o))
    _close(tk.okan_forward(_t(x), _t(grid), _t(coef), _t(sb), _t(ssp),
                           _t(mask), k),
           jk.okan_forward(x, grid, coef, sb, ssp, mask, k), FWD,
           "okan_forward")


def test_regrid_sample_indices_equal_jax_for_every_batch():
    """The knot samples: jnp.linspace(0, b - 1, G + 1) truncated (e-KAN,
    grid sizes 5 and 7) and b / num * arange(num) truncated plus b - 1
    (o-KAN, num 5 and 7), b = 2 ... 4096: all at once through broadcast
    end points, and every 97th b through the scalar call the JAX
    functions make."""
    batches = np.arange(2, 4097)
    for g in (5, 7):
        want = np.asarray(jnp.linspace(0, batches - 1.0, g + 1)
                          .astype(jnp.int32)).T
        got = np.stack([tk._linspace_f32(0.0, b - 1.0, g + 1).long().numpy()
                        for b in batches])
        np.testing.assert_array_equal(got, want)
        steps = jnp.asarray((batches / g).astype(np.float32))[:, None]
        want = np.asarray((steps * jnp.arange(g)).astype(jnp.int32))
        want = np.concatenate([want, batches[:, None] - 1], axis=1)
        got = np.stack([tk._okan_ids(b, g).numpy() for b in batches])
        np.testing.assert_array_equal(got, want)
        for b in batches[::97]:
            np.testing.assert_array_equal(
                tk._linspace_f32(0.0, b - 1.0, g + 1).long().numpy(),
                np.asarray(jnp.linspace(0, b - 1, g + 1).astype(jnp.int32)))
            np.testing.assert_array_equal(
                tk._okan_ids(int(b), g).numpy(), np.asarray(jnp.concatenate(
                    [(int(b) / g * jnp.arange(g)).astype(jnp.int32),
                     jnp.array([b - 1])])))


def _span_close(got, want, what):
    want = np.asarray(want)
    span = want.max(1, keepdims=True) - want.min(1, keepdims=True)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * span), what


@pytest.mark.parametrize("batch", [3, 301])
def test_kan_update_grid_matches_jax(batch):
    """Knots within 1e-6 x span; the refit layer's output on the batch
    within 1e-4 x max|y| of the JAX refit's (with and without the
    scaler; a repeated sample exercises the knot guard)."""
    rng = np.random.default_rng(batch)
    gs, k, i, o = 5, 3, 6, 4
    x = _x(rng, batch, i, scale=0.8)
    x[: batch // 3, 0] = 0.25
    grid = jk.make_grid(i, gs, k)
    sw, sc, bw = _x(rng, o, i, gs + k), _x(rng, o, i), _x(rng, o, i)
    for scaler in (sc, None):
        g_j, w_j = jk.kan_update_grid(x, grid, sw, scaler, grid_size=gs,
                                      spline_order=k)
        g_t, w_t = tk.kan_update_grid(
            _t(x), _t(grid), _t(sw), None if scaler is None else _t(scaler),
            grid_size=gs, spline_order=k)
        _span_close(g_t, g_j, "grid")
        s_t = None if scaler is None else _t(scaler)
        _close(tk.kan_linear(_t(x), g_t, _t(bw), w_t, s_t, k),
               jk.kan_linear(x, g_j, bw, w_j, scaler, k), GRAD, "refit")


@pytest.mark.parametrize("batch", [3, 301])
def test_okan_update_grid_matches_jax(batch):
    rng = np.random.default_rng(10 + batch)
    num, k, i, o = 5, 3, 6, 4
    x = _x(rng, batch, i, scale=0.8)
    x[: batch // 3, 1] = -0.5
    grid = jk.extend_grid(jnp.broadcast_to(jnp.linspace(-1.0, 1.0, num + 1),
                                           (i, num + 1)), k)
    coef, sb, ssp = _x(rng, i, o, num + k), _x(rng, i, o), _x(rng, i, o)
    ones = np.ones((i, o), np.float32)
    g_j, c_j = jk.okan_update_grid(x, grid, coef, k, num)
    g_t, c_t = tk.okan_update_grid(_t(x), _t(grid), _t(coef), k, num)
    _span_close(g_t, g_j, "grid")
    _close(tk.okan_forward(_t(x), g_t, c_t, _t(sb), _t(ssp), _t(ones), k),
           jk.okan_forward(x, g_j, c_j, sb, ssp, ones, k), GRAD, "refit")


# --- the layers and heads ----------------------------------------------------

def _port_key(col, path, kind):
    """A JAX leaf (collection, key path) of a KAN layer / module / head ->
    (the port module's state_dict key, layout map): the head's ``head``
    is the port's ``kan`` for ekan and okan; Dense kernels transpose; a
    BatchNorm's scale / mean / var are weight / running_mean /
    running_var."""
    names = [p.key for p in path]
    if kind in ("ekan", "okan") and names[0] == "head":
        names[0] = "kan"
    leaf = names[-1]
    ren = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}
    key = ".".join(names[:-1] + [ren.get(leaf, leaf)])
    return key, (np.transpose if leaf == "kernel" else np.asarray)


def _port_sd(variables, kind=None):
    """JAX variables -> the port module's state_dict."""
    sd = {}
    for col, tree in variables.items():
        for path, v in jax.tree_util.tree_flatten_with_path(dict(tree))[0]:
            key, fn = _port_key(col, path, kind)
            sd[key] = _t(fn(np.asarray(v)))
            if key.endswith("running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(0)
    return sd


def _jax_vars(jmod, x, tmod, kind):
    """The port module's (seeded) weights as the JAX module's variables:
    the JAX tree's structure from ``eval_shape`` of its init, each leaf
    read from the port's state_dict."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    sd = tmod.state_dict()

    def leaf(col):
        def get(path, shape):
            key, fn = _port_key(col, path, kind)
            a = fn(sd[key].numpy())
            assert a.shape == shape.shape, key
            return a
        return get

    return {col: jax.tree_util.tree_map_with_path(leaf(col), dict(tree))
            for col, tree in shapes.items() if col != "perturbations"}


class _Head(torch.nn.Module):
    """The port's ClassifierHead of ``kind`` alone: the modules of
    ``head_modules`` under the reference's names, and ``classify``."""

    def __init__(self, in_features, num_classes, kind,
                 ekan_spline_order=1):
        super().__init__()
        self.kind = kind
        for name, mod in tm.head_modules(in_features, num_classes, kind,
                                         ekan_spline_order).items():
            self.add_module(name, mod)

    def forward(self, x, update_grid=False):
        return tm.classify(self, self.kind, x, update_grid)


def _seeded(tmod, seed):
    """The port module's init from ``seed``, its BatchNorm drawn away from
    (1, 0, 0, 1) so that the checks see it."""
    gen = torch.Generator().manual_seed(seed)
    for m in tmod.modules():
        if isinstance(m, (tm.KANLinear, tm.OKANLayer)):
            m.reset_parameters(gen)
        elif isinstance(m, torch.nn.Linear):
            torch.nn.init.normal_(m.weight, 0.0, 0.3, generator=gen)
            torch.nn.init.normal_(m.bias, 0.0, 0.3, generator=gen)
        elif isinstance(m, torch.nn.BatchNorm1d):
            with torch.no_grad():
                for t in (m.weight, m.bias, m.running_mean, m.running_var):
                    t.add_(0.3 * torch.rand(t.shape, generator=gen))
    return tmod


# (name, JAX module, port module, whether the JAX module takes ``train``):
# KANLinear at spline order 1 (the in-block KANs' order) and every head
# kind, whose layers are KANLinear at order 3 (ekan), OKANLayer (okan,
# kan_stack), KansModule (kan_module) and ThreeKansModule (3kan)
def _cases(i, o):
    cases = [("kanlinear1", jm.KANLinear(o, spline_order=1),
              tm.KANLinear(i, o, spline_order=1), False)]
    for kind in tm.HEAD_KINDS:
        cases.append((f"head-{kind}",
                      jm.ClassifierHead(o, kind=kind, ekan_spline_order=3),
                      _Head(i, o, kind, ekan_spline_order=3), True))
    return cases


CASE_NAMES = [c[0] for c in _cases(4, 3)]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_layers_and_heads_match_jax(name):
    """In eval and in train mode: the forward within 1e-5 x max, the
    gradients of sum(y * dy) for the input and every parameter within
    1e-4 x max; in train mode the BatchNorm running stats after the step
    (the 3-KAN module's one BatchNorm moves twice)."""
    i, o, b = 12, 5, 16
    jmod, tmod, takes_train = next(c for c in _cases(i, o)
                                   if c[0] == name)[1:]
    kind = name[5:] if name.startswith("head-") else None
    rng = np.random.default_rng(CASE_NAMES.index(name))
    x, dy = _x(rng, b, i), _x(rng, b, o, scale=1.0)
    _seeded(tmod, CASE_NAMES.index(name))
    variables = _jax_vars(jmod, x, tmod, kind)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    sd0 = {k: v.clone() for k, v in tmod.state_dict().items()}
    for train in (False, True):
        tmod.load_state_dict(sd0)
        tmod.train(train)
        kw = dict(train=train) if takes_train else {}

        def loss(p, xx):
            y, upd = jmod.apply({"params": p, **rest}, xx,
                                mutable=["batch_stats"], **kw)
            return jnp.sum(y * dy), (y, upd)

        (_, (y_j, upd)), (g_p, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
        mode = "train" if train else "eval"
        xt = _t(x).requires_grad_(True)
        y_t = tmod(xt)
        _close(y_t, y_j, FWD, f"{mode} forward")
        (y_t * _t(dy)).sum().backward()
        _close(xt.grad, g_x, GRAD, f"{mode} dx")
        got = {n: p.grad for n, p in tmod.named_parameters()}
        want = _port_sd({"params": g_p}, kind)
        assert set(got) == set(want), set(got) ^ set(want)
        for n in want:
            _close(got[n], want[n].numpy(), GRAD, f"{mode} d{n}")
        if train and "batch_stats" in upd:
            sd = tmod.state_dict()
            for n, v in _port_sd({"batch_stats": upd["batch_stats"]},
                                 kind).items():
                if not n.endswith("num_batches_tracked"):
                    _close(sd[n], v.numpy(), FWD, n)
        tmod.zero_grad(set_to_none=True)


@pytest.mark.parametrize("kind", ["ekan", "okan"])
def test_head_update_grid_matches_jax(kind):
    """update_grid on the head: the grid and refit weights through the
    layer's output within 1e-4 x max|y| of the JAX refit, the grid within
    1e-6 x span, the parameter the same object; the other kinds ignore it
    (their state stays bit for bit)."""
    i, o, b = 12, 5, 40
    rng = np.random.default_rng(7)
    x = _x(rng, b, i, scale=0.9)
    jmod = jm.ClassifierHead(o, kind=kind, ekan_spline_order=3)
    tmod = _seeded(_Head(i, o, kind, ekan_spline_order=3), 1)
    variables = _jax_vars(jmod, x, tmod, kind)
    y_j, upd = jax.jit(lambda v, xx: jmod.apply(
        v, xx, update_grid=True, mutable=["kan_state", "params"]))(
        variables, x)
    w_name = "spline_weight" if kind == "ekan" else "coef"
    param = getattr(tmod.kan, w_name)
    with torch.no_grad():
        y_t = tmod(_t(x), update_grid=True)
    assert getattr(tmod.kan, w_name) is param
    _close(y_t, y_j, GRAD, "refit output")
    _span_close(tmod.kan.grid, upd["kan_state"]["head"]["grid"], "grid")


@pytest.mark.parametrize("kind", ["linear", "kan_stack", "kan_module",
                                  "3kan"])
def test_other_heads_ignore_update_grid(kind):
    tmod = _Head(8, 3, kind)
    for m in tmod.modules():
        if isinstance(m, tm.OKANLayer):
            m.reset_parameters(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tmod.eval()
    with torch.no_grad():
        tmod(torch.randn(6, 8), update_grid=True)
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_init_distributions_match_jax():
    """The layers' seeded init draws from the JAX distributions: the grid
    and mask buffers equal, the kaiming-uniform weights within their
    bounds with the spread of U(-b, b), the spline fits to noise of the
    same size."""
    i, o = 64, 48
    x = np.zeros((1, i), np.float32)
    gen = torch.Generator().manual_seed(3)
    for jmod, tmod in ((jm.KANLinear(o, spline_order=3),
                        tm.KANLinear(i, o, spline_order=3)),
                       (jm.OKANLayer(o), tm.OKANLayer(i, o))):
        ref = jax.tree_util.tree_map(np.asarray, dict(
            jax.jit(jmod.init)(jax.random.PRNGKey(0), x)))
        ref.pop("perturbations", None)
        tmod.reset_parameters(gen)
        want = {k: v.numpy() for k, v in _port_sd(ref).items()}
        for k, v in tmod.state_dict().items():
            w, g = want[k], v.numpy()
            assert g.shape == w.shape, k
            if k in ("grid", "mask", "scale_sp"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert abs(g.std() / w.std() - 1) < 0.1, k
                assert abs(g.mean() - w.mean()) < 0.1 * w.std(), k
                assert np.abs(g).max() <= np.abs(w).max() * 1.5, k
