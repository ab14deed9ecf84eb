"""MedSSD at d_state 16 with each KAN head (medssd_ekan, medssd_okan,
medssd_kan, medssd_kanmodule, medssd_3kan) against the JAX package at
``test_torch_ssd16_models.py``'s reduced config cut to one stage
(``HEAD_CFG``), with that file's checks:
fp32 eval logits through both SSD paths, one train step's gradient tree,
bf16 stage dtypes, the weights carried both ways, and for medssd_3kan a
5-step Adam trajectory; and the model-level KAN re-grid
(``kan_grid_update``) of the ekan and okan heads against the JAX
package's."""

import functools

import jax
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.data.image_folder import (
    normalize_batch as jax_normalize,
)
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    kan_grid_update as jax_kan_grid_update,
)
from medical_image_classification_tpu_torch.train.train_step import (
    kan_grid_update,
)
from test_torch_ssd16_models import (
    HEAD,
    _images,
    _jax_model,
    _jax_weights,
    _port,
    _state,
    check_adam_trajectory,
    check_bf16_stage_dtypes,
    check_eval_logits,
    check_train_step_grads,
    check_weights_carry_exactly_both_ways,
)

torch.set_num_threads(2)
HEADS = tuple(HEAD)


@pytest.mark.parametrize("name", HEADS)
def test_eval_logits_match_jax(name, monkeypatch):
    check_eval_logits(name, monkeypatch)


@pytest.mark.parametrize("name", HEADS)
def test_train_step_grads_match_jax(name, monkeypatch):
    check_train_step_grads(name, monkeypatch)


def test_adam_trajectory_matches_jax(monkeypatch):
    check_adam_trajectory("medssd_3kan", monkeypatch)


@pytest.mark.parametrize("name", HEADS)
def test_bf16_stage_dtypes_match_jax(name):
    check_bf16_stage_dtypes(name)


@pytest.mark.parametrize("name", HEADS)
def test_weights_carry_exactly_both_ways(name):
    check_weights_carry_exactly_both_ways(name)


@pytest.mark.parametrize("name", ["medssd_ekan", "medssd_okan"])
def test_kan_grid_update_matches_jax(name):
    """One re-grid of the whole model on a batch (eval mode): the head's
    new grid within 1e-4 x span of JAX's (its knots are the head's inputs,
    which the two backbones compute to their own rounding; the functional
    re-grid on equal inputs is held to 1e-6 in ``test_torch_kan.py``) and
    the model's logits after it
    within 2e-3 x max|logit| of JAX's; the head's parameter stays the same
    object, and no BatchNorm stat and no other parameter moves."""
    import optax
    w = _jax_weights(name)
    imgs, _ = _images(21)
    state = JaxTrainState.create(w["params"], _state(w), optax.adam(1e-4))
    new = jax.jit(functools.partial(jax_kan_grid_update, _jax_model(name)))(
        state, imgs)
    logits_j = np.asarray(jax.jit(_jax_model(name).apply)(
        {"params": new.params, **new.model_state}, jax_normalize(imgs)))
    grid_j = np.asarray(new.model_state["kan_state"]["classifier"]["head"]
                        ["grid"])

    port = _port(name, w).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    w_name = "spline_weight" if name == "medssd_ekan" else "coef"
    param = getattr(port.kan, w_name)
    kan_grid_update(port, torch.from_numpy(imgs))
    assert port.training                      # the mode is given back
    assert getattr(port.kan, w_name) is param
    span = grid_j.max(1, keepdims=True) - grid_j.min(1, keepdims=True)
    assert np.all(np.abs(port.kan.grid.numpy() - grid_j) <= 1e-4 * span)
    moved = sorted(k for k, v in port.state_dict().items()
                   if not torch.equal(v, before[k]))
    assert moved == sorted(["kan.grid", f"kan.{w_name}"])
    with torch.inference_mode():
        from medical_image_classification_tpu_torch.data.image_folder import (
            normalize_batch)
        logits_t = port.eval()(normalize_batch(torch.from_numpy(imgs)))
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                               atol=2e-3 * float(np.abs(logits_j).max()))
