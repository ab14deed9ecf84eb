"""Sequence-parallel training of the port, over gloo ranks on the CPU.

One SP step of the reduced medmamba and medssd of the JAX package's
``tests/test_sp_training.py:12-16`` (the JAX weights carried into the
port): with sp 2 on 2 ranks, and medmamba with dp 2 x sp 2 on 4 ranks
under activation checkpointing, against the JAX SP step (sp 2 on 2
virtual devices; the loss at the JAX test's 1e-5, the gradient tree at
``test_torch_train_parity.py``'s tolerances) and against the port's
unsharded step (the parameters after one Adam step at the JAX test's
2e-4, every gradient leaf).  The JAX step on a dp 2 x sp 2 mesh is no
reference for gradients: its scans' shard_map leaves the batch axis
replicated over 'data', and several leaves' gradients come out at twice
the unsharded step's (Adam, which the JAX test runs, does not see a
leaf's scale).  A reduced st_ssd with DropPath, sp 2, against
the unsharded step.  The ranks are spawned CPU processes
(``torch_parallel_workers.py``)."""

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.parallel import mesh as jmesh
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    make_train_step as jax_make_train_step,
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
from torch_parallel_workers import SP_MODELS, run_step, spawn

torch.set_num_threads(2)

CLASSES, BATCH, SIZE = 3, 4, 32
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight")
CARRY = {"medmamba": (medmamba_state_dict_from_jax,
                      import_medmamba_state_dict),
         "medssd": (medssd_state_dict_from_jax, import_medssd_state_dict)}


def _jax_sp_step(name):
    """JAX weights of the reduced ``name`` (the leaves in PERTURB moved
    from init), a batch, and the JAX SP step with SGD
    at lr 1 (the parameter change is the gradient), on an sp 2 mesh of
    2 devices (dp 1)."""
    cfg = SP_MODELS[name]
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    images[1::2] //= 4
    labels = np.array([0, 1, 2, 0], np.int32)
    model = jax_create(name, num_classes=CLASSES, scan_impl="xla",
                       seq_axis="seq", **cfg)
    jmesh.make_mesh(tp=1, sp=2, devices=jax.devices()[:2])
    try:
        variables = jax.jit(jax_create(name, num_classes=CLASSES,
                                       scan_impl="xla", **cfg).init)(
            {"params": jax.random.PRNGKey(0)},
            np.zeros((1, SIZE, SIZE, 3), np.float32))
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))

        def perturb(node):
            return {k: (perturb(v) if isinstance(v, dict) else
                        np.asarray(v) + (0.2 * rng.standard_normal(
                            np.shape(v)).astype(np.float32)
                            if k in PERTURB else 0.0))
                    for k, v in node.items()}

        params = perturb(to_np(variables["params"]))
        stats = to_np(variables["batch_stats"])
        state = JaxTrainState.create(params, {"batch_stats": stats},
                                     optax.sgd(1.0))
        new_state, m = jax_make_train_step(model, donate=False)(
            state, images, labels, jax.random.PRNGKey(1))
    finally:
        jmesh.set_current_mesh(None)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   state.params, new_state.params)
    return dict(sd=CARRY[name][0](params, stats), images=images,
                labels=labels, loss=float(m["loss"]), grads=grads)


@pytest.fixture(scope="module")
def jax_steps():
    return {name: _jax_sp_step(name) for name in SP_MODELS}


def _payload(name, sd, images, labels, sp, **cfg):
    return dict(name=name, classes=CLASSES, sd=sd, images=images,
                labels=labels, opt="adam", lr=1e-3, sp=sp,
                cfg={**SP_MODELS.get(name, {}), **cfg,
                     **({"seq_axis": "seq"} if sp > 1 else {})})


def _check_against_one(ranks, one, what, floor=1e-7):
    """Every rank: the loss of the unsharded step; every gradient leaf
    within rel-norm 1e-4 over an error norm of ``floor`` (a conv bias that
    feeds a BatchNorm has a true gradient of 0); the parameters after the
    Adam step within 2e-4 (the JAX test's tolerance) and the BatchNorm
    running stats within 1e-5 of each leaf's scale."""
    for r, out in enumerate(ranks):
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-5, abs=1e-5)
        for n, want in one["grads"].items():
            err = float((out["grads"][n] - want).double().norm())
            assert err <= floor or err <= 1e-4 * float(want.norm()), \
                (what, r, n, err, float(want.norm()))
        for k, want in one["sd"].items():
            got = out["sd"][k]
            if k.endswith(("running_mean", "running_var")):
                tol = 1e-5 * float(want.abs().max())
            elif want.is_floating_point():
                tol = 2e-4
            else:
                assert torch.equal(got, want), (what, r, k)
                continue
            assert float((got - want).abs().max()) <= tol, (what, r, k)


@pytest.mark.parametrize("name,world", [("medmamba", 2), ("medssd", 2),
                                        ("medmamba", 4)])
def test_sp_step_matches_jax_and_unsharded(tmp_path, jax_steps, name,
                                           world):
    """sp 2 over ``world`` ranks (dp world // 2): the loss and the gradient
    tree against the JAX SP step on the same global batch of 4, and the
    port's unsharded step.  The 4-rank run also checkpoints every block
    (``use_checkpoint``: the recompute issues the scan's and the
    BatchNorm's collectives again inside the backward)."""
    j = jax_steps[name]
    extra = dict(use_checkpoint=True) if world == 4 else {}
    p = _payload(name, j["sd"], j["images"], j["labels"], 2, **extra)
    ranks = spawn("step", world, tmp_path, p)
    one = run_step(_payload(name, j["sd"], j["images"], j["labels"], 1))
    _check_against_one(ranks, one, name)
    cfg = SP_MODELS[name]
    kw = dict(depths=cfg["depths"], dims=cfg["dims"])
    kw.update(d_state=cfg["d_state"]) if name == "medmamba" else \
        kw.update(headdim=cfg["ssd_headdim"])
    for out in ranks:
        assert out["loss"] == pytest.approx(j["loss"], rel=1e-5, abs=1e-5)
        sd = {k: out["grads"].get(k, v) for k, v in out["sd"].items()}
        g, _ = CARRY[name][1](sd, **kw)
        _assert_tree_close(g, j["grads"], 2e-2, 0.998, 2e-4)


def test_sp_st_ssd_step_matches_unsharded(tmp_path):
    """A reduced st_ssd (the ST tail's BatchNorm and token mixers on the
    replicated stack, the SSD scan L-sharded) with DropPath at 0.6, sp 2 on
    2 ranks: the seq ranks draw the same masks as one process, and the step
    is the unsharded step's."""
    cfg = dict(depths=(1, 1), dims=(16, 32), d_state=4, ssd_headdim=8,
               st_tokens=(8, 4), drop_path_rate=0.6)
    model = create_model("st_ssd", CLASSES, generator=torch.Generator()
                         .manual_seed(5), **cfg)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = np.array([0, 1, 2, 1], np.int32)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sp2, sp1 = (dict(_payload("st_ssd", sd, images, labels, sp, **cfg),
                     seed=3) for sp in (2, 1))
    ranks = spawn("step", 2, tmp_path, sp2)
    one = run_step(sp1)
    assert len(one["masks"]) == 1 and not bool(one["masks"][0].all())
    for out in ranks:
        assert torch.equal(out["masks"][0], one["masks"][0])
    _check_against_one(ranks, one, "st_ssd")
