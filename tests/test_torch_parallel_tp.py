"""Tensor-parallel training of the port over 2 gloo ranks on the CPU.

One tp-2 step of the reduced medmamba and medssd of the JAX package's
``tests/test_sharding.py:25-35`` (batch 8 at 32x32, the weights moved
from init and carried into both packages) against the JAX step on
``make_mesh(tp=2)`` over 2 virtual devices, which GSPMD computes as the
unsharded step: with SGD at lr 1 (the update is the gradient) the loss,
the logits, the gradient of every leaf joined over the ranks and the
BatchNorm running stats, at the tolerances of
``test_torch_train_parity.py::test_train_step_matches_jax``.  Against the
port's one-process step (whose gradient the SGD step holds to JAX): one
Adam step of medmamba at ``tests/test_sharding.py:74-81``'s tolerances
(rtol 0.1, atol 2e-4), a global-norm clip that clips, and one lamb step
(its trust ratio over the full tensors).  The helpers here carry the
weights and run the JAX step on a mesh for the other
``test_torch_parallel_tp*.py`` files.  The ranks are spawned CPU
processes (``torch_parallel_workers.py``)."""

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.data.image_folder import (
    normalize_batch as jax_normalize,
)
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.parallel import mesh as jmesh
from medical_image_classification_tpu.parallel.sharding import shard_state
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    make_train_step_fn as jax_make_train_step_fn,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medmamba_state_dict,
    import_medssd_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.utils.weights import (
    medmamba_state_dict_from_jax,
    medssd_state_dict_from_jax,
)
from test_torch_train_parity import _assert_tree_close
from torch_parallel_workers import run_step, spawn

torch.set_num_threads(2)

# tests/test_sharding.py:25-35's reduced models, batch 8 at 32x32
SMALL = dict(depths=(1, 1), dims=(16, 32), drop_path_rate=0.0, ssd_headdim=8,
             d_state=4)
CLASSES, BATCH, SIZE = 4, 8, 32
# the JAX leaves moved away from init
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight",
           "k_weights", "mean")
CARRY = {"medmamba": lambda w: medmamba_state_dict_from_jax(
    w["params"], w["batch_stats"])}
TP_AXES = {"model_axis": "model"}
# the state_dict's entries that are no parameters
BUFFERS = ("running_mean", "running_var", "num_batches_tracked", "grid")


def carry(name, w):
    """JAX weights {params, batch_stats[, kan_state]} (or a gradient tree
    in place of params) as the port's state_dict."""
    if name in CARRY:
        return CARRY[name](w)
    return medssd_state_dict_from_jax(w["params"], w["batch_stats"],
                                      w.get("kan_state"))


def _imported(name, cfg):
    """The port's seeded init of ``name`` as the JAX trees, through the JAX
    package's importer (no JAX program to compile), or None for a name
    without one."""
    sd = create_model(name, CLASSES, generator=torch.Generator()
                      .manual_seed(0), **cfg).state_dict()
    shape = {k: cfg[k] for k in ("depths", "dims")}
    if name == "medmamba":
        params, stats = import_medmamba_state_dict(
            sd, d_state=cfg["d_state"], **shape)
    elif name in ("medssd", "st_ssd"):
        params, stats = import_medssd_state_dict(
            sd, headdim=cfg["ssd_headdim"], st_tokens="st_tokens" in cfg,
            **shape)
    else:
        return None
    return {"params": params, "batch_stats": stats}


def jax_weights(name, cfg, seed=0):
    """The init of the reduced ``name`` at SIZE as the JAX trees (the
    port's, imported, or the JAX model's), the PERTURB leaves moved from
    it: {collection: nested dicts of numpy arrays}."""
    variables = _imported(name, cfg)
    if variables is None:
        model = jax_create(name, num_classes=CLASSES, **cfg)
        variables = jax.jit(model.init)(
            {"params": jax.random.PRNGKey(0)},
            np.zeros((1, SIZE, SIZE, 3), np.float32))
    rng = np.random.default_rng(seed)

    def perturb(node):
        return {k: (perturb(v) if hasattr(v, "items") else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32)
                                     if k in PERTURB else 0.0))
                for k, v in node.items()}

    return {col: perturb(jax.tree_util.tree_map(np.asarray, dict(t)))
            for col, t in variables.items()}


def batch(seed=0):
    """BATCH images whose halves differ visibly (per-rank statistics could
    not pass) and their labels."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    images[1::2] //= 4
    return images, (np.arange(BATCH) % CLASSES).astype(np.int32)


def jax_step(name, cfg, w, images, labels, tx, tp=2, sp=1):
    """The JAX train step of ``name`` from the weights ``w`` on a
    (tp, sp) mesh over the first tp * sp virtual devices (dp 1), and the
    train-mode logits of the same forward (one program): {loss, logits,
    params and batch_stats after the step (numpy trees)}."""
    model = jax_create(name, num_classes=CLASSES, **cfg,
                       **({"seq_axis": "seq"} if sp > 1 else {}))
    mesh = jmesh.make_mesh(tp=tp, sp=sp, devices=jax.devices()[:tp * sp])
    rest = {k: v for k, v in w.items() if k != "params"}
    try:
        state = shard_state(JaxTrainState.create(w["params"], rest, tx),
                            mesh)
        bsh = jmesh.batch_sharding(mesh)
        x = jax.device_put(images, bsh)
        y = jax.device_put(labels, bsh)
        step = jax_make_train_step_fn(model)

        def run(st, x, y):
            logits = model.apply({"params": st.params, **st.model_state},
                                 jax_normalize(x), train=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})[0]
            return step(st, x, y, jax.random.PRNGKey(0)) + (logits,)

        new, m, logits = jax.jit(run)(state, x, y)
    finally:
        jmesh.set_current_mesh(None)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    return dict(loss=float(m["loss"]), logits=np.asarray(logits),
                params=to_np(new.params),
                batch_stats=to_np(new.model_state["batch_stats"]))


def jax_grads(name, w, new):
    """The SGD-at-lr-1 step's gradient (params - new params) under the
    port's names."""
    g = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                               w["params"], new["params"])
    return carry(name, dict(w, params=g))


def payload(name, cfg, w, images, labels, opt="sgd", lr=1.0, tp=2, **kw):
    """A ``run_step`` payload: the port's weights carried from ``w``, the
    model built with the model axis (and the seq axis with ``sp``)."""
    sp = kw.get("sp", 1)
    axes = {**(TP_AXES if tp > 1 else {}),
            **({"seq_axis": "seq"} if sp > 1 else {})}
    return dict(name=name, classes=CLASSES, cfg={**cfg, **axes},
                sd=carry(name, w), images=images, labels=labels.astype(
                    np.int64), opt=opt, lr=lr, tp=tp, **kw)


def check_against_jax(out, j, name, w, want=None):
    """A rank's step against the JAX step: the loss within 2e-4, the
    logits within 1e-4 x max|logit|, every gradient leaf within rel-norm
    2e-2 and cosine 0.998 above 2e-4 (``_assert_tree_close``; ``want``:
    the gradients under the port's names, by default the step's), the
    BatchNorm running stats within 1e-5 of each leaf's scale."""
    assert abs(out["loss"] - j["loss"]) <= 2e-4 * abs(j["loss"]), \
        (name, out["loss"], j["loss"])
    logits = out["logits"].numpy()
    np.testing.assert_allclose(logits, j["logits"], rtol=0,
                               atol=1e-4 * np.abs(j["logits"]).max())
    want = jax_grads(name, w, j) if want is None else want
    got = {k: out["grads"][k].numpy() for k in out["grads"]}
    assert set(got) == {k for k in want if not k.endswith(BUFFERS)}
    _assert_tree_close(got, {k: want[k].numpy() for k in got}, 2e-2, 0.998,
                       2e-4)
    stats = carry(name, dict(w, batch_stats=j["batch_stats"]))
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                out["sd"][k].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-5 * float(v.abs().max()), err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def setup():
    images, labels = batch()
    ws = {name: jax_weights(name, SMALL) for name in ("medmamba", "medssd")}
    return images, labels, ws


def test_tp_steps_match_jax_and_one_process(tmp_path, setup):
    """One spawn of 2 ranks (tp 2, dp 1): medmamba and medssd with SGD at
    lr 1 against the JAX tp-2 step; medmamba with one Adam step at lr
    1e-3 against the port's one-process Adam step (rtol 0.1, atol 2e-4);
    medmamba with SGD and a global-norm clip of 0.05, which the gradient's
    norm exceeds, against the port's one-process clipped step (every
    parameter after the step within 1e-6 of its scale)."""
    images, labels, ws = setup
    sgd = {name: payload(name, SMALL, w, images, labels)
           for name, w in ws.items()}
    adam = payload("medmamba", SMALL, ws["medmamba"], images, labels,
                   opt="adam", lr=1e-3)
    clip = payload("medmamba", SMALL, ws["medmamba"], images, labels,
                   lr=0.1, clip=0.05)
    lamb = payload("medssd", SMALL, ws["medssd"], images, labels,
                   opt="lamb", lr=1e-2)
    ranks = spawn("steps", 2, tmp_path,
                  [sgd["medmamba"], sgd["medssd"], adam, clip, lamb])
    for r in (0, 1):
        for k, t in ranks[r][0]["grads"].items():
            assert torch.equal(t, ranks[0][0]["grads"][k]), (r, k)
    for i, name in enumerate(sgd):
        j = jax_step(name, SMALL, ws[name], images, labels, optax.sgd(1.0))
        for out in (ranks[0][i], ranks[1][i]):
            check_against_jax(out, j, name, ws[name])

    one = run_step({**adam, "cfg": SMALL})
    for out in (ranks[0][2], ranks[1][2]):
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for k, v in one["sd"].items():
            np.testing.assert_allclose(out["sd"][k].numpy(), v.numpy(),
                                       rtol=0.1, atol=2e-4, err_msg=k)

    one = run_step({**clip, "cfg": SMALL})
    full = run_step({**clip, "cfg": SMALL, "clip": None})
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in full["grads"].values())))
    assert norm > 2 * clip["clip"]
    # each parameter's update that of one process: the clip scales all of
    # them by the full tree's norm (one rank's norm would miss the other
    # rank's pieces of the split leaves)
    for out in (ranks[0][3], ranks[1][3]):
        for k in one["grads"]:
            want = one["sd"][k] - clip["sd"][k]
            err = float((out["sd"][k] - one["sd"][k]).double().norm())
            assert err <= 1e-4 * float(want.double().norm()) + 1e-9, \
                (k, err, float(want.norm()))

    # lamb's per-tensor trust ratio over the full tensors: each leaf's
    # update that of one process (a ratio over one rank's piece would
    # scale a split leaf's by its piece's norms), but for the conv biases
    # that feed a BatchNorm: their gradient is 0 up to fp32 noise, which
    # the normalised update turns into a step of ~lr
    one = run_step({**lamb, "cfg": SMALL})
    noise = {k for k in one["grads"]
             if k.endswith(("conv33conv33conv11.1.bias",
                            "conv33conv33conv11.4.bias"))}
    assert len(noise) == 4 and all(float(one["grads"][k].norm()) < 1e-6
                                   for k in noise)
    for out in (ranks[0][4], ranks[1][4]):
        for k, v in one["sd"].items():
            if k not in noise:
                np.testing.assert_allclose(out["sd"][k].numpy(), v.numpy(),
                                           rtol=0, atol=2e-5, err_msg=k)
