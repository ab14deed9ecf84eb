"""The three CrossMamba classifiers of the port against the JAX package's
``CrossVSSMClassifier``: "stage3" (cross_cls_stage3), "stage3_merged"
(cross_cls_3e1fadd1e) and "all" (cross_cls_4ef), at the JAX package's
test config (depths 1-1-1-1, dims 8..64, d_state 4, headdim 4; the
fusions at d_state 128), 32x32, fp32, drop path off; eval at batch 2, the
gradients at batch 4: at 32x32 the fourth stage is 1x1, and a train-mode
BatchNorm over two samples a channel maps them to +-1 whatever they are,
so its backward is all cancellation and fp32 rounding (cross_cls_3e1fadd1e
read a 2.4% rel-norm gap at batch 2, every leaf upstream of its shared
stage scaled alike, cosine 0.9999997).

The port's seeded weights, drawn away from init, go to JAX through the
JAX importer (``import_cross_classifier_state_dict``), inputs from a numpy
seed; one jitted JAX program per mode gives the eval logits and the train
loss (batch statistics) with its gradient tree.  Logits within 2e-3 x
max|logit| (rtol 0), the loss within 2e-4 relative, every parameter's
gradient within leaf rel-norm 2e-2 and cosine 0.998; the two-input train
step's first loss is that loss; the carrier is the importer's exact
inverse.  At this size every SSD takes the einsum path on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.models.crossmamba import (
    CrossVSSMClassifier as JaxCrossClassifier,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_cross_classifier_state_dict,
)
from medical_image_classification_tpu_torch.models import create_fusion_model
from medical_image_classification_tpu_torch.models.crossmamba import (
    CrossVSSMClassifier,
)
from medical_image_classification_tpu_torch.train.eval_step import (
    make_cross_eval_step,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    cross_entropy_loss,
    make_cross_train_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    cross_classifier_state_dict_from_jax,
)
from test_torch_crossmamba import (
    assert_scaled,
    flat_shapes,
    grads_close,
    perturb_,
)

torch.set_num_threads(2)

MODES = {"stage3": "cross_cls_stage3", "stage3_merged": "cross_cls_3e1fadd1e",
         "all": "cross_cls_4ef"}
CFG = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), d_state=4,
           ssd_headdim=4)
NUM_CLASSES, BATCH, GRAD_BATCH, SIZE = 5, 2, 4, 32


def _port(mode):
    model = create_fusion_model(MODES[mode], num_classes=NUM_CLASSES,
                                drop_path_rate=0.0, **CFG)
    return perturb_(model, 7)


def _jax_vars(state_dict, mode):
    sd = {k: v.numpy() for k, v in state_dict.items()}
    return import_cross_classifier_state_dict(
        sd, depths=CFG["depths"], dims=CFG["dims"],
        headdim=CFG["ssd_headdim"], fuse_mode=mode)


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    xa, xb = (rng.random((n, SIZE, SIZE, 3), dtype=np.float32)
              for _ in range(2))
    return xa, xb, rng.integers(0, NUM_CLASSES, (n,), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_results(mode):
    """One jitted program: the eval logits on batch 1, the train loss and
    its gradient tree on batch 2 (of GRAD_BATCH)."""
    params, stats = _jax_vars(_port(mode).state_dict(), mode)
    model = JaxCrossClassifier(num_classes=NUM_CLASSES, fuse_mode=mode,
                               drop_path_rate=0.0, **CFG)
    (ea, eb, _), (ta, tb, labels) = _batch(1), _batch(2, GRAD_BATCH)

    def run(params):
        logits = model.apply({"params": params, "batch_stats": stats}, ea,
                             eb, train=False)

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, ta, tb,
                                 train=True, mutable=["batch_stats"])
            logp = jax.nn.log_softmax(out)
            return -jnp.mean(logp[jnp.arange(GRAD_BATCH), labels])

        return logits, jax.value_and_grad(loss_fn)(params)

    logits, (loss, grads) = jax.jit(run)(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np.asarray(logits), float(loss), to_np(grads), stats


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_classifier_matches_jax(mode):
    """Eval logits through the two-input eval step, then one train-mode
    loss and every parameter's gradient on another batch."""
    logits_j, loss_j, grads_j, stats = _jax_results(mode)
    port = _port(mode)
    xa, xb, labels = (torch.from_numpy(a) for a in _batch(1))
    _, logits = make_cross_eval_step(port)(xa, xb, labels.long())
    assert logits.dtype == torch.float32
    assert_scaled(logits.numpy(), logits_j)
    np.testing.assert_array_equal(logits.numpy().argmax(-1),
                                  logits_j.argmax(-1))
    ta, tb, tl = (torch.from_numpy(a) for a in _batch(2, GRAD_BATCH))
    port.train()
    loss = cross_entropy_loss(port(ta, tb), tl.long())
    loss.backward()
    assert abs(float(loss.detach()) - loss_j) <= 2e-4 * abs(loss_j)
    want = cross_classifier_state_dict_from_jax(grads_j, stats, mode)
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    grads_close(got, {n: want[n].numpy() for n in got})


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_train_step_loss_and_update(mode):
    """make_cross_train_step's first loss is the train-mode loss above;
    Adam moves every parameter but the fourth stage's A_logs (at 1x1 the
    scan has one step, which A does not reach: a zero gradient, in JAX
    too); the BatchNorms move their stats."""
    _, loss_j, grads_j, stats = _jax_results(mode)
    port = _port(mode)
    grads = cross_classifier_state_dict_from_jax(grads_j, stats, mode)
    zero = sorted(n for n, _ in port.named_parameters()
                  if not grads[n].any())
    assert zero and all(n.endswith("A_logs") for n in zero), zero
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = make_optimizer("adam", port.named_parameters())
    step = make_cross_train_step(port, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)), state=TrainState())
    ta, tb, tl = (torch.from_numpy(a) for a in _batch(2, GRAD_BATCH))
    m = step(ta, tb, tl.long())
    assert abs(float(m["loss"]) - loss_j) <= 2e-4 * abs(loss_j)
    still = sorted(n for n, p in port.named_parameters()
                   if torch.equal(p, before[n]))
    assert still == zero
    assert not torch.equal(before[next(k for k in before if k.endswith(
        "running_mean"))], port.state_dict()[next(
            k for k in before if k.endswith("running_mean"))])


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_classifier_carrier_round_trip(mode):
    """Port state_dict -> JAX importer -> carrier gives every tensor back
    bit for bit and loads strictly; the importer's trees have the JAX
    model's structure and shapes (``jax.eval_shape`` of its init)."""
    sd = _port(mode).state_dict()
    params, stats = _jax_vars(sd, mode)
    back = cross_classifier_state_dict_from_jax(params, stats, mode)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k
    create_fusion_model(MODES[mode], num_classes=NUM_CLASSES,
                        **CFG).load_state_dict(back, strict=True)
    model = JaxCrossClassifier(num_classes=NUM_CLASSES, fuse_mode=mode,
                               **CFG)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x))
    assert flat_shapes(shapes["params"]) == flat_shapes(params)
    assert flat_shapes(shapes["batch_stats"]) == flat_shapes(stats)


def test_unknown_fuse_mode_raises():
    with pytest.raises(ValueError, match="fuse_mode"):
        CrossVSSMClassifier(NUM_CLASSES, fuse_mode="stage2", **CFG)
