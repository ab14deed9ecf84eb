"""A reduced ST-SSD built in the JAX package and carried into the port:
eval logits (fp32 against the JAX package, bf16 against fp32), one train
step's whole gradient tree against the JAX step, a 5-step Adam trajectory,
the state_dict keys through the JAX importer, and the init distributions.

The reduced model keeps ST-SSD's structure at 32x32 with two stages
(depths 1-1, dims 128-256, d_state 16 so N = 64, headdim 32, p = 8 and 4
tokens per side).  With the gates widened to these shapes on both sides,
as the JAX package's kernel tests widen them, every stage takes all three
kernels: Y_diag (one chunk, l 64 and 16), the STL mixer and the STF gate
(the port's plain versions; the JAX kernels in Pallas interpret mode),
forward and, in training, backward through their custom VJPs and the
port's autograd Functions.  DropPath is off on both sides: the two
frameworks' random streams cannot be matched."""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu.kernels.stf_zgate_pallas as jszp
import medical_image_classification_tpu.kernels.stl_mixer_pallas as jsmp
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
import medical_image_classification_tpu_torch.kernels.stf_zgate as tszp
import medical_image_classification_tpu_torch.kernels.stl_mixer as tsmp
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
    make_train_step_fn as jax_make_train_step_fn,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medssd_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.models.ss2d_modules import (
    _adaptive_bins,
    lecun_normal_,
)
from medical_image_classification_tpu_torch.train.eval_step import (
    make_eval_step,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    make_train_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    st_ssd_state_dict_from_jax,
)

torch.set_num_threads(2)

CFG = dict(depths=(1, 1), dims=(128, 256), d_state=16, ssd_headdim=32,
           st_tokens=(8, 4))
IMPORT_CFG = dict(depths=CFG["depths"], dims=CFG["dims"], headdim=32,
                  st_tokens=True)
NUM_CLASSES, BATCH, SIZE = 8, 4, 32
# the JAX leaves moved away from init (norm scales and biases, the SSD
# parameters, the WMF weights, o_norm's running mean)
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight",
           "k_weights", "mean")


def _widen(mp):
    """The gates of all three kernels opened to the reduced shapes, on
    both sides; the JAX kernels in interpret mode."""
    for mod in (jyd, jsmp, jszp):
        mp.setattr(mod, "_INTERPRET", True)
    mp.setattr(jyd, "_MIN_L", 8)
    mp.setattr(tyd, "_MIN_L", 8)
    for mod in (jsmp, tsmp):
        mp.setattr(mod, "_MIN_LP", 8 * 8)
    for mod in (jszp, tszp):
        mp.setattr(mod, "_MIN_PP", 8 * 8)


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    _widen(monkeypatch)


@pytest.fixture(scope="module")
def jax_model_and_weights():
    with pytest.MonkeyPatch.context() as mp:
        _widen(mp)
        model = jax_create("st_ssd", num_classes=NUM_CLASSES,
                           drop_path_rate=0.0, **CFG)
        variables = jax.jit(model.init)(
            {"params": jax.random.PRNGKey(0)},
            np.zeros((1, SIZE, SIZE, 3), np.float32))
    rng = np.random.default_rng(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))

    def perturb(node):
        return {k: (perturb(v) if isinstance(v, dict) else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32)
                                     if k in PERTURB else 0.0))
                for k, v in node.items()}

    return model, perturb(to_np(variables["params"])), \
        perturb(to_np(variables["batch_stats"]))


def _port(params, stats, **kw):
    model = create_model("st_ssd", NUM_CLASSES, drop_path_rate=0.0, **CFG,
                         **kw)
    model.load_state_dict(st_ssd_state_dict_from_jax(params, stats),
                          strict=True)
    return model


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, NUM_CLASSES, (BATCH,), dtype=np.int32))


def test_eval_logits_match_jax(jax_model_and_weights, monkeypatch):
    """Logits within 2e-3 x max|logit| with the same argmax (fp32: the
    plain versions, the einsum paths and the norms sum in other orders
    than the JAX kernels and XLA); each plain version ran once per stage."""
    model, params, stats = jax_model_and_weights
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.sgd(1e-3))
    imgs, labels = _images(1)
    _, logits_j = jax_make_eval_step(model)(state, imgs, labels)
    calls = []
    for mod, name in ((tyd, "ydiag_fused_ref"), (tsmp, "stl_mixer_fwd_ref"),
                      (tszp, "stf_zgate_fwd_ref")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name:
                            calls.append(name) or fn(*a))
    _, logits_t = make_eval_step(_port(params, stats))(
        torch.from_numpy(imgs), torch.from_numpy(labels).long())
    assert sorted(calls) == sorted(["ydiag_fused_ref", "stl_mixer_fwd_ref",
                                    "stf_zgate_fwd_ref"] * 2)
    assert logits_t.dtype == torch.float32
    assert logits_t.shape == (BATCH, NUM_CLASSES)
    logits_j = np.asarray(logits_j)
    scale = float(np.abs(logits_j).max())
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                               atol=2e-3 * scale)
    np.testing.assert_array_equal(logits_t.numpy().argmax(-1),
                                  logits_j.argmax(-1))


def _train_port(params, stats, optimizer, lr):
    port = _port(params, stats)
    opt = make_optimizer(optimizer, port.named_parameters())
    return port, make_train_step(port, opt, make_lr_scheduler(
        opt, make_schedule("constant", lr)), state=TrainState())


def _kernel_calls(monkeypatch):
    """Count the plain forward and backward of each of the three kernels."""
    calls = []
    for mod, names in ((tyd, ("ydiag_fused_ref", "ydiag_fused_bwd_ref")),
                       (tsmp, ("stl_mixer_fwd_ref", "stl_mixer_bwd_ref")),
                       (tszp, ("stf_zgate_fwd_ref", "stf_zgate_bwd_ref"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name:
                                calls.append(name) or fn(*a))
    return calls


def _assert_tree_close(got, want, rtol, min_cos, abs_floor):
    """Leaf-wise rel-norm and cosine (tests/test_reference_grad_parity.py
    :70-98): a leaf passes if its error norm is under ``abs_floor`` or its
    rel-norm error is <= rtol with cosine > min_cos."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    for (key, g), (_, w) in zip(flat_g, flat_w):
        g = np.asarray(g, np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        diff = np.linalg.norm(g - w)
        if diff <= abs_floor:
            continue
        nw = np.linalg.norm(w)
        cos = float(g @ w / (np.linalg.norm(g) * nw + 1e-30))
        assert diff / nw <= rtol, (f"{jax.tree_util.keystr(key)}: rel-norm "
                                   f"{diff / nw:.3e} (cos {cos:.6f})")
        assert cos > min_cos, f"{jax.tree_util.keystr(key)}: cos {cos:.6f}"


def test_train_step_grads_match_jax(jax_model_and_weights, monkeypatch):
    """One train step from the same weights on the same batch; the JAX step
    runs with SGD at lr 1, so its parameter change is its gradient.  Loss
    within 2e-4 relative; every parameter's gradient leaf-wise within
    rel-norm 2e-2 and cosine 0.998 above an abs floor of 2e-4 (the ladder
    of tests/test_reference_grad_parity.py:70; fp32, the plain backwards,
    the einsum SSD and the norms sum in other orders than the JAX kernels
    and XLA).  Each kernel's plain backward ran once per stage, so every
    gradient came through the three Functions."""
    model, params, stats = jax_model_and_weights
    imgs, labels = _images(3)
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.sgd(1.0))
    new_state, metrics = jax.jit(jax_make_train_step_fn(model))(
        state, imgs, labels, jax.random.PRNGKey(0))
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                     state.params, new_state.params)

    calls = _kernel_calls(monkeypatch)
    port, step = _train_port(params, stats, "sgd", 1.0)
    m = step(torch.from_numpy(imgs), torch.from_numpy(labels).long())
    assert sorted(calls) == sorted(
        ["ydiag_fused_ref", "stl_mixer_fwd_ref", "stf_zgate_fwd_ref",
         "ydiag_fused_bwd_ref", "stl_mixer_bwd_ref", "stf_zgate_bwd_ref"]
        * 2)
    loss_j = float(metrics["loss"])
    assert abs(float(m["loss"]) - loss_j) <= 2e-4 * abs(loss_j)
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else v).detach()
             for k, v in port.state_dict().items()}
    grads_t, _ = import_medssd_state_dict(grads, **IMPORT_CFG)
    _assert_tree_close(grads_t, grads_j, 2e-2, 0.998, 2e-4)


def test_adam_trajectory_matches_jax(jax_model_and_weights):
    """Adam at lr 1e-4, a new batch each step, 5 steps: the per-step losses
    within rtol 1e-2 (the ladder of the MedMamba and MedSSD trajectory
    tests: Adam divides by sqrt(v), so fp32 gradient noise near zero grows
    over the steps), and every parameter moved."""
    model, params, stats = jax_model_and_weights
    batches = [_images(10 + i) for i in range(5)]
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.adam(1e-4))
    step_j = jax_make_train_step(model, donate=False)
    losses_j = []
    for imgs, labels in batches:
        state, metrics = step_j(state, imgs, labels, jax.random.PRNGKey(0))
        losses_j.append(float(metrics["loss"]))

    port, step = _train_port(params, stats, "adam", 1e-4)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    losses_t = [float(step(torch.from_numpy(i),
                           torch.from_numpy(l).long())["loss"])
                for i, l in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2, atol=2e-4)
    still = [n for n, p in port.named_parameters()
             if torch.equal(p, before[n])]
    assert not still, still


def test_trains_after_an_eval(jax_model_and_weights):
    """An eval forward (inference mode) and then a train step, with the STF
    pooling matrices made by the eval: the train step back-propagates and
    matches the same step on a fresh model (the cached matrices were once
    inference tensors, which autograd cannot save; the smoke run on the
    card evals st_ssd before it trains it)."""
    _, params, stats = jax_model_and_weights
    imgs, labels = (torch.from_numpy(a) for a in _images(4))
    labels = labels.long()
    _adaptive_bins.cache_clear()
    port, step = _train_port(params, stats, "sgd", 1e-2)
    make_eval_step(port)(imgs, labels)
    loss = float(step(imgs, labels)["loss"])
    _adaptive_bins.cache_clear()
    _, step2 = _train_port(params, stats, "sgd", 1e-2)
    assert loss == float(step2(imgs, labels)["loss"])


def test_bf16_logits_close_to_fp32(jax_model_and_weights):
    """dtype=bf16 (fp32 parameters) against fp32 on the same weights:
    within 0.1 x max|logit| (bf16 activations through two blocks and three
    rounded kernels each)."""
    _, params, stats = jax_model_and_weights
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, SIZE, SIZE, 3), dtype=np.float32))
    port, port16 = _port(params, stats), _port(params, stats,
                                               dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    with torch.inference_mode():
        y32, y16 = port.eval()(x), port16.eval()(x)
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    scale = float(y32.abs().max())
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=0,
                               atol=0.1 * scale)


def _flat(tree, dtype=None):
    return {jax.tree_util.keystr(k): np.asarray(v, dtype) for k, v in
            jax.tree_util.tree_flatten_with_path(dict(tree))[0]}


def test_state_dict_roundtrips_through_jax_importer(jax_model_and_weights):
    """st_ssd_state_dict_from_jax is the exact inverse of
    import_medssd_state_dict(st_tokens=True), batch stats included."""
    _, params, stats = jax_model_and_weights
    params2, stats2 = import_medssd_state_dict(
        _port(params, stats).state_dict(), **IMPORT_CFG)
    for want, got in ((_flat(params), _flat(params2)),
                      (_flat(stats), _flat(stats2))):
        assert set(want) == set(got), set(want) ^ set(got)
        for k in want:
            assert want[k].shape == got[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any("o_norm" in k for k in _flat(stats))


def test_init_distributions_match_jax():
    """The port's seeded init draws from the JAX package's distributions:
    constant leaves are equal (k_weights 0.25, o_norm), the large random
    leaves agree in mean and spread (u1, u2 and z U[0, 1), o_linear
    kaiming), and the STL/STF mix weights are Flax's Dense default,
    lecun-normal, not the trunc-normal(0.02) of the port's Linears."""
    with pytest.MonkeyPatch.context() as mp:
        _widen(mp)
        model = jax_create("st_ssd", num_classes=NUM_CLASSES, **CFG)
        ref = jax.jit(model.init)({"params": jax.random.PRNGKey(4)},
                                  np.zeros((1, SIZE, SIZE, 3), np.float32))
    port = create_model("st_ssd", NUM_CLASSES,
                        generator=torch.Generator().manual_seed(4), **CFG)
    got, got_stats = import_medssd_state_dict(port.state_dict(),
                                              **IMPORT_CFG)
    checked = set()
    for want_tree, got_tree in ((ref["params"], got),
                                (ref["batch_stats"], got_stats)):
        want_f, got_f = _flat(want_tree, np.float64), _flat(got_tree,
                                                            np.float64)
        assert set(want_f) == set(got_f)
        for k, w in want_f.items():
            g = got_f[k]
            assert g.shape == w.shape, k
            if w.std() == 0:
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif w.size >= 256:
                n = len(np.unique(w))
                assert abs(g.std() / w.std() - 1) < 5 / np.sqrt(n), k
                assert abs(g.mean() - w.mean()) < \
                    5 * w.std() * np.sqrt(2 / n), k
            checked.add(k.split("'")[-2])
    assert {"u1", "u2", "z", "k_weights", "mean"} <= checked
    # the [2, 1] mix kernels: every one inside lecun-normal's cut (+-2 std
    # of 1/sqrt(2) corrected), and the distribution itself by sampling
    std = np.sqrt(0.5) / .87962566103423978
    mix = [v for k, v in _flat(got, np.float64).items()
           if "'mix'" in k and "kernel" in k]
    assert len(mix) == 4
    assert all(np.abs(m).max() <= 2 * std + 1e-6 for m in mix)
    g = lecun_normal_(torch.empty(20000), 2,
                      torch.Generator().manual_seed(0)).numpy()
    w = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (2, 10000))).ravel()
    assert abs(g.std() / w.std() - 1) < 0.03
    assert abs(g.max() - w.max()) < 0.05 and abs(g.min() - w.min()) < 0.05
