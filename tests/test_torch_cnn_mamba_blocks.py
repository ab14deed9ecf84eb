"""CNN-Mamba's blocks against the JAX package's, on the CPU, inputs from a
numpy seed: ``ConvTConvPW`` (the RGB pre-stem, one BatchNorm at both call
sites), ``ECALayer`` and ``MIFABlock``, forward within 1e-5 x max and the
input and parameter gradients within 1e-4 x max in fp32, the stem in
train and eval mode with its running stats after a train step (moved
twice); MIFA's output dtype for a bf16 input (fp32 on both sides: its
convs have no compute dtype); the seeded init against the JAX
distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from medical_image_classification_tpu.models import common as jc
from medical_image_classification_tpu_torch.models import common as tc

torch.set_num_threads(2)
FWD, GRAD = 1e-5, 1e-4


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _port_key(path, stem=False):
    """A JAX leaf path -> the port's state_dict key, and the layout maps
    JAX -> port and back; the stem's ``pw`` is the reference's
    ``PW_conv``."""
    names = [p.key for p in path]
    if stem:
        names = ["PW_conv" if n == "pw" else n for n in names]
    leaf = names[-1]
    ren = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}
    key = ".".join(names[:-1] + [ren.get(leaf, leaf)])
    if leaf != "kernel":
        return key, np.asarray, np.asarray
    # HWIO (or WIO) -> OIHW (or OIW), and back
    perm = lambda nd: (nd - 1, nd - 2) + tuple(range(nd - 2))
    return (key, lambda a: np.transpose(a, perm(a.ndim)),
            lambda a: np.transpose(a, np.argsort(perm(a.ndim))))


def _jax_vars(jmod, x, tmod, stem=False):
    """The port module's weights as the JAX module's variables."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    sd = tmod.state_dict()

    def leaf(path, shape):
        key, _, back = _port_key(path, stem)
        a = back(sd[key].numpy())
        assert a.shape == shape.shape, (key, a.shape, shape.shape)
        return a

    return {col: jax.tree_util.tree_map_with_path(leaf, dict(tree))
            for col, tree in shapes.items()}


def _grads_by_key(tree, stem=False):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(dict(tree))[0]:
        key, fn, _ = _port_key(path, stem)
        out[key] = fn(np.asarray(v))
    return out


def _seeded(tmod, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in tmod.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var") or name.endswith("bn.weight"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            else:
                t.copy_(0.4 * torch.randn(t.shape, generator=gen))
    return tmod


CASES = {
    "stem": (lambda: jc.ConvTConvPW(channels=3), lambda: tc.ConvTConvPW(3),
             (2, 9, 9, 3), True),
    "eca": (lambda: jc.ECALayer(), lambda: tc.ECALayer(), (2, 5, 5, 12),
            False),
    "mifa": (lambda: jc.MIFABlock(8), lambda: tc.MIFABlock(8), (2, 6, 6, 8),
             False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_match_jax(name):
    """fp32: forward and gradients of sum(y * dy); the stem in eval and
    train mode (its one BatchNorm's running stats after the step, moved
    twice)."""
    make_j, make_t, shape, has_bn = CASES[name]
    jmod, tmod = make_j(), _seeded(make_t(), 3)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    stem = name == "stem"
    variables = _jax_vars(jmod, x, tmod, stem)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    sd0 = {k: v.clone() for k, v in tmod.state_dict().items()}
    for train in ((False, True) if has_bn else (False,)):
        tmod.load_state_dict(sd0)
        tmod.train(train)
        kw = dict(train=train) if has_bn else {}

        def loss(p, xx):
            y, upd = jmod.apply({"params": p, **rest}, xx,
                                mutable=["batch_stats"], **kw)
            return jnp.sum(y * dy), (y, upd)

        (_, (y_j, upd)), (g_p, g_x) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
        xt = torch.from_numpy(x).requires_grad_(True)
        y_t = tmod(xt)
        _close(y_t, y_j, FWD, "forward")
        (y_t * torch.from_numpy(dy)).sum().backward()
        _close(xt.grad, g_x, GRAD, "dx")
        want = _grads_by_key(g_p, stem)
        got = {n: p.grad for n, p in tmod.named_parameters()}
        assert set(got) == set(want), set(got) ^ set(want)
        # a conv bias just before the BatchNorm has a zero gradient (the
        # norm takes the mean away): both sides hold rounding noise there,
        # so each leaf's scale is at least 1e-2 of the tree's
        top = max(float(np.abs(v).max()) for v in want.values())
        for n in want:
            scale = max(float(np.abs(want[n]).max()), 1e-2 * top)
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0,
                                       atol=GRAD * scale, err_msg=n)
        if train:
            sd = tmod.state_dict()
            for n, v in _grads_by_key(upd["batch_stats"], stem).items():
                _close(sd[n], v, FWD, n)
            assert int(sd["bn.num_batches_tracked"]) == 2
        tmod.zero_grad(set_to_none=True)


def test_mifa_promotes_bf16_to_fp32():
    """A bf16 stream enters MIFA and leaves it in fp32 on both sides (the
    JAX module's convs have no dtype, so Flax promotes to the fp32
    parameters); ECA's gate takes the activation's dtype."""
    x = np.random.default_rng(0).standard_normal((2, 6, 6, 8))
    jmod, tmod = jc.MIFABlock(8), _seeded(tc.MIFABlock(8), 1)
    xb = jnp.asarray(x, jnp.bfloat16)
    out = jax.eval_shape(jmod.apply, _jax_vars(jmod, xb, tmod), xb)
    with torch.no_grad():
        y = tmod(torch.from_numpy(x).bfloat16())
    assert out.dtype == jnp.float32 and y.dtype == torch.float32
    eca = tc.ECALayer()
    with torch.no_grad():
        assert eca(torch.ones(1, 2, 2, 4, dtype=torch.bfloat16)).dtype \
            == torch.bfloat16


def test_init_distributions_match_jax():
    """The seeded init (as ``VSSM.reset_parameters`` draws it) against the
    JAX init: ECA's lecun-normal 1-D kernel, MIFA's and the stem's
    kaiming-normal (fan_out) convs, zero biases, the stem's BatchNorm at
    (1, 0)."""
    from medical_image_classification_tpu_torch.models.common import (
        kaiming_conv_)
    x = np.zeros((1, 4, 4, 64), np.float32)
    gen = torch.Generator().manual_seed(0)
    for jmod, tmod in ((jc.MIFABlock(64), tc.MIFABlock(64)),
                       (jc.ConvTConvPW(3), tc.ConvTConvPW(3))):
        for m in tmod.modules():
            if isinstance(m, torch.nn.Conv2d):
                kaiming_conv_(m.weight, gen)
                torch.nn.init.zeros_(m.bias)
            elif isinstance(m, tc.ECALayer):
                m.reset_parameters(gen)
        ref = jax.jit(jmod.init)(jax.random.PRNGKey(0), x[..., :3]
                                 if isinstance(jmod, jc.ConvTConvPW) else x)
        want = _grads_by_key(ref["params"], isinstance(jmod,
                                                       jc.ConvTConvPW))
        sd = tmod.state_dict()
        for k, w in want.items():
            g = sd[k].numpy()
            assert g.shape == w.shape, k
            if w.std() == 0:
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif w.size >= 64:
                assert abs(g.std() / w.std() - 1) < 0.25, k
    # ECA's three taps: pooled over many draws, and within the cut at
    # +-2 std (Flax's lecun_normal is a truncated normal, fan_in 3)
    eca = tc.ECALayer()
    draws = []
    for s in range(400):
        eca.reset_parameters(torch.Generator().manual_seed(s))
        draws.append(eca.conv.weight.detach().numpy().ravel().copy())
    init = jax.jit(jc.ECALayer().init)
    jw = np.concatenate([np.asarray(init(jax.random.PRNGKey(s), x)["params"]
                                    ["conv"]["kernel"]).ravel()
                         for s in range(400)])
    draws = np.concatenate(draws)
    assert abs(draws.std() / jw.std() - 1) < 0.1
    assert np.abs(draws).max() <= 2 * np.sqrt(1 / 3) / .87962566 + 1e-6

