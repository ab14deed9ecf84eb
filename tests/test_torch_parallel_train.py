"""Data-parallel training of the port over 2 gloo ranks on the CPU.

One DP step of the reduced medmamba of the JAX package's
``tests/test_sharding.py`` (batch 8 at 32x32, the JAX weights carried
into the port) against the JAX step on ``make_mesh(tp=1)``: the loss, the
gradient tree and the BatchNorm running stats at the tolerances of
``test_torch_train_parity.py::test_train_step_matches_jax``; against the
port's one-process step on the global batch, every gradient leaf; again
with DropPath on (the port against itself, each rank's masks the global
batch's rows at rank::2).  A reduced medssd_ekan re-grids under DP to
the same grids on both ranks as one process on the global batch.  And
``cli/ddp_train.py`` over 2 ranks on a generated ImageFolder: an epoch,
``--auto-resume`` to the next, and ``--sp 2``, each checkpoint against
one process's ``cli/train.py`` on the global batch; rank 0 alone logs.
The ranks are spawned CPU processes (``torch_parallel_workers.py``)."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.parallel import mesh as jmesh
from medical_image_classification_tpu.parallel.sharding import shard_state
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    make_train_step_fn as jax_make_train_step_fn,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medmamba_state_dict,
)
from medical_image_classification_tpu_torch.cli import train as cli_train
from medical_image_classification_tpu_torch.models import (
    create_model,
    registry,
)
from medical_image_classification_tpu_torch.utils.weights import (
    medmamba_state_dict_from_jax,
)
from test_torch_train_parity import _assert_tree_close
from torch_parallel_workers import run_regrid, run_step, spawn

torch.set_num_threads(2)

# tests/test_sharding.py:25-35's reduced medmamba, batch 8 at 32x32
SMALL = dict(depths=(1, 1), dims=(16, 32), drop_path_rate=0.0, ssd_headdim=8,
             d_state=4)
CLASSES, BATCH, SIZE = 4, 8, 32


@pytest.fixture(scope="module")
def jax_dp_step():
    """The JAX weights (norm scales and biases moved away from init), the
    batch, and the JAX step on make_mesh(tp=1) with SGD at lr 1 (the
    parameter change is the gradient)."""
    model = jax_create("medmamba", num_classes=CLASSES, **SMALL)
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

    params = perturb(to_np(variables["params"]))
    stats = to_np(variables["batch_stats"])
    # the two halves of the batch with visibly different statistics:
    # per-rank BatchNorm statistics cannot pass
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    images[1::2] //= 4
    labels = (np.arange(BATCH) % CLASSES).astype(np.int32)
    mesh = jmesh.make_mesh(tp=1)
    try:
        state = shard_state(JaxTrainState.create(
            params, {"batch_stats": stats}, optax.sgd(1.0)), mesh)
        bsh = jmesh.batch_sharding(mesh)
        new_state, metrics = jax.jit(jax_make_train_step_fn(model))(
            state, jax.device_put(images, bsh), jax.device_put(labels, bsh),
            jax.random.PRNGKey(0))
    finally:
        jmesh.set_current_mesh(None)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   state.params, new_state.params)
    return dict(params=params, stats=stats, images=images, labels=labels,
                loss=float(metrics["loss"]),
                accuracy=float(metrics["accuracy"]), grads=grads,
                new_stats=to_np(new_state.model_state["batch_stats"]))


def _payload(j, **cfg):
    return dict(name="medmamba", classes=CLASSES, cfg={**SMALL, **cfg},
                sd=medmamba_state_dict_from_jax(j["params"], j["stats"]),
                images=j["images"], labels=j["labels"], opt="sgd", lr=1.0)


def _jax_tree(sd, grads=None):
    """A port state_dict (with its gradients in place of the parameters)
    as the JAX trees."""
    if grads is not None:
        sd = {k: grads.get(k, v) for k, v in sd.items()}
    return import_medmamba_state_dict(sd, **{k: SMALL[k] for k in
                                             ("depths", "dims", "d_state")})


def _same_leaves(ranks, key, one, rel, floor=1e-7):
    """Every rank's ``key`` dict equal to the one-process dict, leaf-wise
    within rel-norm ``rel`` of each leaf whose error norm is over ``floor``
    (the conv biases that feed a BatchNorm have a true gradient of 0, and
    fp32 noise of ~1e-9 on both sides), and exactly equal across ranks."""
    for name, want in one[key].items():
        for r, out in enumerate(ranks):
            got = out[key][name]
            assert torch.equal(got, ranks[0][key][name]), (r, name)
            err = float((got - want).double().norm())
            assert err <= floor or err <= rel * float(want.double().norm()), \
                (key, name, err, float(want.norm()))


def test_dp_step_matches_jax_and_one_process(tmp_path, jax_dp_step):
    """Two ranks of 4 images each, against the JAX DP step on the global
    batch of 8 and the port's one-process step on it; then with DropPath
    at rate 0.3, the port against itself."""
    j = jax_dp_step
    p = _payload(j)
    ranks = spawn("step", 2, tmp_path, p)
    one = run_step(p)
    for out in ranks:
        assert abs(out["loss"] - j["loss"]) <= 2e-4 * abs(j["loss"])
        assert out["accuracy"] == pytest.approx(j["accuracy"])
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
    # the gradient tree against JAX, the running stats within 1e-5 of each
    # leaf's scale
    g_params, _ = _jax_tree(ranks[0]["sd"], ranks[0]["grads"])
    _assert_tree_close(g_params, j["grads"], 2e-2, 0.998, 2e-4)
    _, stats = _jax_tree(ranks[0]["sd"])
    flat_t = jax.tree_util.tree_flatten_with_path(stats)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(j["new_stats"])[0]
    assert len(flat_t) == len(flat_j) == 6 * sum(SMALL["depths"])
    for (key, t), (_, w) in zip(flat_t, flat_j):
        np.testing.assert_allclose(np.asarray(t), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(key))
    # against one process on the global batch: every gradient leaf, the
    # parameters after the step and the running stats
    _same_leaves(ranks, "grads", one, 1e-5)
    _same_leaves(ranks, "sd", one, 1e-5)

    p = _payload(j, drop_path_rate=0.3)
    ranks = spawn("step", 2, tmp_path, p)
    one = run_step(p)
    # the rates run 0 .. 0.3 over the two blocks: the second draws
    assert len(one["masks"]) == 1 and not bool(one["masks"][0].all())
    for r, out in enumerate(ranks):
        assert len(out["masks"]) == 1
        for m, full in zip(out["masks"], one["masks"]):
            assert torch.equal(m, full[r::2])
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
    _same_leaves(ranks, "grads", one, 1e-5)


def test_dp_kan_regrid_matches_one_process(tmp_path):
    """A reduced medssd_ekan re-grids on each rank's shard of 8 images:
    both ranks end with the same grids and spline weights, those of one
    process's re-grid on the global batch."""
    cfg = dict(depths=(1, 1), dims=(16, 32), d_state=4, ssd_headdim=8,
               drop_path_rate=0.0)
    model = create_model("medssd_ekan", 3, generator=torch.Generator()
                         .manual_seed(3), **cfg)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    images[1::2] //= 3
    p = dict(name="medssd_ekan", classes=3, cfg=cfg, images=images,
             sd={k: v.clone() for k, v in model.state_dict().items()})
    ranks = spawn("regrid", 2, tmp_path, p)
    one = run_regrid(p)
    moved = [k for k in ("kan.grid", "kan.spline_weight")
             if not torch.equal(one[k], p["sd"][k])]
    assert moved == ["kan.grid", "kan.spline_weight"]
    for out in ranks:
        for k, want in one.items():
            torch.testing.assert_close(out[k], want, rtol=1e-6, atol=1e-7,
                                       msg=k)


# --------------------------------------------------------------- the CLI

TINY = dict(depths=(1, 1), dims=(16, 32), d_state=4, drop_path_rate=0.1)


def _image_folder(root, n=4, size=32):
    import cv2
    rng = np.random.RandomState(0)
    for split, count in (("train", n), ("val", 2)):
        for cls in ("a", "b"):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(count):
                img = rng.randint(0, 256, (size, size, 3), np.uint8)
                cv2.imwrite(os.path.join(d, f"{i}.png"),
                            img // (1 + 3 * (i % 2)))


def _ckpt(save, epoch):
    return torch.load(os.path.join(save, f"epoch_{epoch}.pt"),
                      weights_only=True)


def _same_model(got, want, what):
    """Two checkpoints' model state: every floating leaf within rel-norm
    1e-5 of the one-process leaf over an error norm of 1e-6."""
    for k, w in want["model"].items():
        g = got["model"][k]
        if not w.is_floating_point():
            assert torch.equal(g, w), (what, k)
            continue
        err = float((g - w).double().norm())
        assert err <= 1e-6 or err <= 1e-5 * float(w.double().norm()), \
            (what, k, err)


def test_ddp_train_cli(tmp_path, monkeypatch):
    """cli/ddp_train.py over 2 ranks (gloo, --device cpu, global batch 4,
    SGD): one epoch, then ``--auto-resume --epochs 2`` continues at epoch
    1; each epoch's checkpoint equals one process's cli/train.py run on
    the global batch (the same shuffles, augmentations and DropPath
    masks), rank 0 alone writes the log; ``--sp 2`` over 2 ranks gives the
    same epoch 0."""
    root = str(tmp_path / "oct")
    _image_folder(root)
    argv = ["--data-path", os.path.join(root, "train"), "--num-classes", "2",
            "--batch-size", "4", "--image-size", "32", "--device", "cpu",
            "--num-workers", "1", "--log-every", "1", "--optimizer", "sgd",
            "--lr", "0.05", "--dist-backend", "gloo"]
    dp_save = str(tmp_path / "dp" / "m.ckpt")
    p = dict(name="medmamba", cfg=TINY,
             argv=argv + ["--save-path", dp_save, "--epochs", "1",
                          "--auto-resume"])
    spawn("cli", 2, tmp_path, p)
    assert sorted(os.listdir(dp_save)) == ["epoch_0.pt"]
    p["argv"] = argv + ["--save-path", dp_save, "--epochs", "2",
                        "--auto-resume"]
    spawn("cli", 2, tmp_path, p)
    assert sorted(os.listdir(dp_save)) == ["epoch_0.pt", "epoch_1.pt"]
    log = open(os.path.join(tmp_path, "dp", "train.log")).read()
    for line in ("epoch 0 done", "resumed from", "epoch 1 done",
                 "epoch 1 val top-1"):
        assert log.count(line) == 1, (line, log)
    assert "mesh {'data': 2, 'model': 1, 'seq': 1}" in log

    sp_save = str(tmp_path / "sp" / "m.ckpt")
    p["argv"] = argv + ["--save-path", sp_save, "--epochs", "1", "--sp", "2"]
    spawn("cli", 2, tmp_path, p)
    assert "mesh {'data': 1, 'model': 1, 'seq': 2}" in open(
        os.path.join(tmp_path, "sp", "train.log")).read()

    one_save = str(tmp_path / "one" / "m.ckpt")
    monkeypatch.setitem(registry._REGISTRY, "medmamba",
                        lambda num_classes, **kw: registry.medmamba(
                            num_classes, **{**kw, **TINY}))
    cli_train.main(cli_train.parse_args(
        argv + ["--save-path", one_save, "--epochs", "2"]))
    for epoch in (0, 1):
        got, want = _ckpt(dp_save, epoch), _ckpt(one_save, epoch)
        assert got["step"] == want["step"] == 2 * (epoch + 1)
        _same_model(got, want, f"dp epoch {epoch}")
    _same_model(_ckpt(sp_save, 0), _ckpt(one_save, 0), "sp epoch 0")
