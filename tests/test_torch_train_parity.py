"""The port's train step against the JAX package's, at a reduced MedMamba
built in the JAX package and carried into the port: one step (loss, the
whole gradient tree, the BatchNorm running stats after it), a short Adam
trajectory, and the label-smoothed cross-entropy.  DropPath is off on both
sides: the two frameworks' random streams cannot be matched."""

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    cross_entropy_loss as jax_cross_entropy_loss,
    make_train_step as jax_make_train_step,
    make_train_step_fn as jax_make_train_step_fn,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medmamba_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    cross_entropy_loss,
    make_train_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    medmamba_state_dict_from_jax,
)

torch.set_num_threads(2)

CFG = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), d_state=8)
NUM_CLASSES, BATCH, SIZE = 8, 2, 64


@pytest.fixture(scope="module")
def jax_model_and_weights():
    """The JAX model, its params moved away from init (norm scales and
    biases: init has them at 1 and 0) and its init batch stats, as numpy."""
    model = jax_create("medmamba", num_classes=NUM_CLASSES,
                       drop_path_rate=0.0, **CFG)
    # jitted: eager init dispatches thousands of small ops
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, SIZE, SIZE, 3), np.float32))
    rng = np.random.default_rng(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))

    def perturb(node):
        return {k: (perturb(v) if isinstance(v, dict) else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32)
                                     if k in ("bias", "scale") else 0.0))
                for k, v in node.items()}

    return model, perturb(to_np(variables["params"])), \
        to_np(variables["batch_stats"])


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, NUM_CLASSES, (BATCH,), dtype=np.int32))
            for _ in range(n)]


def _port(params, stats, optimizer, lr):
    model = create_model("medmamba", NUM_CLASSES, drop_path_rate=0.0, **CFG)
    model.load_state_dict(medmamba_state_dict_from_jax(params, stats),
                          strict=True)
    opt = make_optimizer(optimizer, model.named_parameters())
    sched = make_lr_scheduler(opt, make_schedule("constant", lr))
    return model, make_train_step(model, opt, sched, state=TrainState())


def _to_jax_trees(model, grads=False):
    """The port's parameters (or their gradients) and BatchNorm stats as
    the JAX trees, through the JAX package's importer."""
    sd = model.state_dict()
    if grads:
        named = dict(model.named_parameters())
        sd = {k: (named[k].grad if k in named else v) for k, v in sd.items()}
    return import_medmamba_state_dict(
        {k: v.detach() for k, v in sd.items()}, **CFG)


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


def test_train_step_matches_jax(jax_model_and_weights):
    """One train step from the same weights on the same batch.  The JAX
    step runs with SGD at lr 1, so its parameter change is its gradient.
    Loss within 2e-4 relative; the whole gradient tree leaf-wise within
    rel-norm 2e-2 and cosine 0.998 above an abs floor of 2e-4 (fp32, the
    scans and the Weff projection sum in other orders); the BatchNorm
    running stats after the step within 1e-5 of each leaf's scale (the
    biased batch variance, momentum 0.9)."""
    model, params, stats = jax_model_and_weights
    imgs, labels = _batches(1, 1)[0]
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.sgd(1.0))
    new_state, metrics = jax.jit(jax_make_train_step_fn(model))(
        state, imgs, labels, jax.random.PRNGKey(0))
    grads_j = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                     state.params, new_state.params)

    port, step = _port(params, stats, "sgd", 1.0)
    m = step(torch.from_numpy(imgs), torch.from_numpy(labels).long())
    loss_j = float(metrics["loss"])
    assert abs(float(m["loss"]) - loss_j) <= 2e-4 * abs(loss_j)
    assert float(m["accuracy"]) == pytest.approx(float(metrics["accuracy"]))

    grads_t, _ = _to_jax_trees(port, grads=True)
    _assert_tree_close(grads_t, grads_j, 2e-2, 0.998, 2e-4)

    _, stats_t = _to_jax_trees(port)
    flat_t = jax.tree_util.tree_flatten_with_path(stats_t)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(
        dict(new_state.model_state["batch_stats"]))[0]
    assert len(flat_t) == len(flat_j) == 6 * sum(CFG["depths"])
    for (key, t), (_, j) in zip(flat_t, flat_j):
        j = np.asarray(j)
        np.testing.assert_allclose(np.asarray(t), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max(),
                                   err_msg=jax.tree_util.keystr(key))


@pytest.mark.parametrize("steps", [5, pytest.param(20, marks=pytest.mark.slow)])
def test_adam_trajectory_matches_jax(jax_model_and_weights, steps):
    """Adam at lr 1e-4, a new batch each step: the per-step losses of the
    two stacks within rtol 1e-2 (Adam divides by sqrt(v), so fp32 gradient
    noise near zero grows over the steps)."""
    model, params, stats = jax_model_and_weights
    batches = _batches(2, steps)
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.adam(1e-4))
    step_j = jax_make_train_step(model, donate=False)
    losses_j = []
    for imgs, labels in batches:
        state, metrics = step_j(state, imgs, labels, jax.random.PRNGKey(0))
        losses_j.append(float(metrics["loss"]))

    _, step = _port(params, stats, "adam", 1e-4)
    losses_t = [float(step(torch.from_numpy(i),
                           torch.from_numpy(l).long())["loss"])
                for i, l in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2, atol=2e-4)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((6, 5))).astype(np.float32)
    labels = rng.integers(0, 5, (6,))
    want = float(jax_cross_entropy_loss(logits, labels, smoothing))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    # bf16 logits are taken to fp32 before the softmax, as in JAX
    got16 = cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels), smoothing)
    want16 = float(jax_cross_entropy_loss(
        np.asarray(torch.from_numpy(logits).bfloat16().float()), labels,
        smoothing))
    assert float(got16) == pytest.approx(want16, rel=1e-6)
