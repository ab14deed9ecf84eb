"""Tensor parallelism beside the data and seq axes, over 4 gloo ranks on
the CPU.

The reduced medmamba of ``test_torch_parallel_tp.py`` (the JAX weights
carried into the port), one spawn of 4 ranks running two meshes in turn:

* dp 2 x tp 2 with DropPath at rate 0.3 and activation checkpointing
  (each block's collectives run again in its recompute), against the
  port's one-process step on the global batch of 8: each rank's masks
  are its data rank's rows of the global batch's (the two model ranks of
  a data rank draw the same), the loss and every gradient leaf joined
  over the model axis those of one process.
* tp 2 x sp 2 (dp 1, the scans L-sharded and d_inner split): the loss,
  the logits, the running stats and every gradient leaf against the JAX
  step on ``make_mesh(tp=2, sp=2)`` over 4 devices, which the JAX package
  runs, but for the patch embed's and the conv branches' convolution
  kernels, whose gradient that JAX step returns twice over (pinned here
  against the port's one-process step, which every leaf of the port's
  tp 2 x sp 2 step matches), as its dp 2 x sp 2 step does of other leaves
  (``test_torch_parallel_sp.py``)."""

import optax
import pytest
import torch

from test_torch_parallel_tp import (
    SMALL,
    batch,
    carry,
    check_against_jax,
    jax_grads,
    jax_step,
    jax_weights,
    payload,
)
from torch_parallel_workers import run_step, spawn

torch.set_num_threads(1)

# the leaves whose gradient the JAX tp 2 x sp 2 step doubles
DOUBLED = ("patch_embed.proj.weight",) + tuple(
    f"layers.{i}.blocks.0.conv33conv33conv11.{j}.weight"
    for i in (0, 1) for j in (1, 4))


def test_tp_with_dp_and_with_sp(tmp_path):
    images, labels = batch(2)
    w = jax_weights("medmamba", SMALL, seed=2)
    drop = dict(SMALL, drop_path_rate=0.3)
    p_dp = payload("medmamba", dict(drop, use_checkpoint=True), w, images,
                   labels)
    p_sp = payload("medmamba", SMALL, w, images, labels, sp=2)
    ranks = spawn("steps", 4, tmp_path, [p_dp, p_sp])

    one = run_step({**p_dp, "cfg": drop})
    _check_against_one(ranks, 0, one, masks=True)

    # the same weights without DropPath: one process, then the JAX step
    one = run_step({**p_sp, "cfg": SMALL})
    _check_against_one(ranks, 1, one)
    j = jax_step("medmamba", SMALL, w, images, labels, optax.sgd(1.0), sp=2)
    g_jax = jax_grads("medmamba", w, j)
    for k in DOUBLED:
        ratio = float(g_jax[k].norm() / one["grads"][k].norm())
        assert ratio == pytest.approx(2.0, rel=1e-3), (k, ratio)
        g_jax[k] = g_jax[k] / 2
    for _, out in ranks:
        check_against_jax(out, j, "medmamba", w, g_jax)
    assert carry("medmamba", w).keys() == ranks[0][1]["sd"].keys()


def _check_against_one(ranks, i, one, masks=False):
    """Payload ``i`` of every rank against one process: the loss, every
    gradient leaf within rel-norm 1e-4 over an error norm of 1e-7 (a conv
    bias that feeds a BatchNorm has a true gradient of 0); with ``masks``
    each rank's DropPath masks its data rank's rows of the global
    batch's."""
    if masks:
        # the rates run 0 .. 0.3 over the two blocks: the second draws
        assert len(one["masks"]) == 1 and not bool(one["masks"][0].all())
    for r, res in enumerate(ranks):
        out = res[i]
        if masks:
            assert len(out["masks"]) == 1
            assert torch.equal(out["masks"][0], one["masks"][0][r // 2::2])
        assert out["loss"] == pytest.approx(one["loss"], rel=1e-6)
        for k, want in one["grads"].items():
            got = out["grads"][k]
            assert got.shape == want.shape, k
            err = float((got - want).double().norm())
            assert err <= 1e-7 or err <= 1e-4 * float(want.norm()), \
                (r, i, k, err, float(want.norm()))
