"""The port's optimizers and learning-rate schedules against the JAX
package's optax factory: each of the 9 optimizers, with and without
gradient clipping and the weight-decay mask, and each of the 8 schedules,
over 5 updates from the same parameters and gradients, and the decay mask
against the JAX mask on MedMamba's parameter tree.  Tolerance 1e-5: optax
computes in fp32, torch's optimizers in fp32 in another order, and the
schedules in float64 against optax's fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
    make_schedule as jax_make_schedule,
    no_weight_decay_mask as jax_no_weight_decay_mask,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medmamba_state_dict,
    import_medssd_family_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
    no_weight_decay_mask,
)

OPTIMIZERS = ["adam", "adamw", "sgd", "momentum", "nesterov", "rmsprop",
              "adagrad", "lamb", "lion"]
SCHEDULES = ["constant", "step", "multistep", "exponential", "cosine",
             "warmup_cosine", "warmup_constant", "fusion_exp"]
SHAPES = {"w": (3, 4), "A_logs": (2, 3), "bias": (4,)}
STEPS = 5


def _run_both(name, schedule_kw, weight_decay=0.0, grad_clip=None,
              masked=False):
    """STEPS updates of the JAX optimizer and the port's from the same
    parameters and gradients (numpy, seeded).  Returns both final
    parameter dicts and the JAX mask."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: 2 * rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]

    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    mask_j = jax_no_weight_decay_mask(params_j) if masked else None
    tx = jax_make_optimizer(name, jax_make_schedule(**schedule_kw),
                            weight_decay=weight_decay, grad_clip=grad_clip,
                            no_decay_mask=mask_j)
    opt_state = tx.init(params_j)
    for g in grads:
        up, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  opt_state, params_j)
        params_j = optax.apply_updates(params_j, up)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    mask_t = no_weight_decay_mask(module) if masked else None
    opt = make_optimizer(name, module.named_parameters(),
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         no_decay_mask=mask_t)
    sched = make_lr_scheduler(opt, make_schedule(**schedule_kw))
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
    got = {k: p.detach().numpy() for k, p in module.items()}
    return got, {k: np.asarray(v) for k, v in params_j.items()}, mask_j


@pytest.mark.parametrize("variant", ["plain", "clip_mask"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, variant):
    """Decay 0.01 (adamw, lamb and lion use it); ``clip_mask`` adds
    clip_by_global_norm(1.0) (the gradients' norm is ~9, so every step
    clips) and the decay mask, which spares A_logs and bias.  The lr
    decays by 0.7 a step, so a factory that applies it at another point of
    the chain (optax's rmsprop scales before its momentum trace) differs."""
    kw = dict(name="exponential", base_lr=1e-2, steps_per_epoch=1,
              gamma=0.7)
    if variant == "plain":
        got, want, _ = _run_both(name, kw, weight_decay=0.01)
    else:
        got, want, mask = _run_both(name, kw, weight_decay=0.01,
                                    grad_clip=1.0, masked=True)
        assert {k: bool(v) for k, v in mask.items()} == \
            {"w": True, "A_logs": False, "bias": False}
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_optax(name):
    """Each schedule's value at steps 0..39, counted from the first update
    (steps_per_epoch 3, so the step, multistep, exponential and warmup
    boundaries fall inside), and 5 SGD updates driven by it."""
    kw = dict(name=name, base_lr=0.1, steps_per_epoch=3, epochs=6,
              warmup_epochs=1, step_size=2, gamma=0.5, milestones=(1, 3),
              min_lr=0.01, decay=0.75)
    sched_j, sched_t = jax_make_schedule(**kw), make_schedule(**kw)
    for step in range(40):
        assert sched_t(step) == pytest.approx(float(sched_j(step)),
                                              rel=1e-5, abs=1e-9), step
    got, want, _ = _run_both("sgd", dict(kw, steps_per_epoch=1))
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# the SSD-family names at d_state 16 and the reference head kinds they
# carry (the JAX importer's ``head``)
SSD16_HEADS = {"cnn_mamba": "linear", "cnn_mamba_mifa": "linear",
               "kanin_ssd": "linear", "kanout_ssd": "linear",
               "medssd_ekan": "ekan", "medssd_okan": "okan",
               "medssd_kan": "kan_stack", "medssd_kanmodule": "kan_module",
               "medssd_3kan": "3kan"}


def _mask_tree(name, cfg, headdim):
    """The port's mask of a reduced ``name`` as the JAX params tree (1.0
    decayed, 0.0 not), through the JAX importer and, for MIFA and the
    in-block KANs, which the reference does not name,
    ``jax_trees_of_port_names``; kaninSSD's in_proj, which the importer
    reads, is a stand-in dropped again."""
    model = create_model(name, 3, ssd_headdim=headdim, **cfg)
    mask = no_weight_decay_mask(model)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    sd = {k: (torch.full_like(v, float(mask[k])) if k in mask
              else torch.zeros_like(v, dtype=torch.float32))
          for k, v in model.state_dict().items()}
    feed = dict(sd)
    for k in [k for k in sd if k.endswith("in_proj_kan.base_weight")]:
        feed[k.replace("in_proj_kan.base_weight", "in_proj.weight")] = sd[k]
    params, _ = import_medssd_family_state_dict(
        feed, head=SSD16_HEADS[name], headdim=headdim,
        conv_stem=name.startswith("cnn_mamba"), **cfg)
    if name == "kanin_ssd":
        for key, layer in params.items():
            for sub, blk in layer.items() if key.startswith("layers_") \
                    else ():
                if sub.startswith("blocks_"):
                    blk["self_attention"].pop("in_proj")
    from test_torch_ssd16_models import jax_trees_of_port_names
    extra = jax_trees_of_port_names(sd)["params"]

    def merge(a, b):
        for k, v in b.items():
            a[k] = merge(a.get(k, {}), v) if isinstance(v, dict) else v
        return a

    return merge(params, extra)


def test_no_weight_decay_mask_matches_jax():
    """The port's mask on a reduced MedMamba and on each SSD-family model
    at d_state 16 (the CNN-Mamba stem and MIFA, the in-block KANs, every
    KAN head: a 1-D BatchNorm's weight is not decayed), carried through
    the JAX package's importer, equals the JAX mask on the same tree."""
    cfg = dict(depths=(1, 1), dims=(16, 32), d_state=4)
    model = create_model("medmamba", 3, **cfg)
    mask = no_weight_decay_mask(model)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    sd = {k: (torch.full_like(v, float(mask[k])) if k in mask
              else torch.zeros_like(v, dtype=torch.float32))
          for k, v in model.state_dict().items()}
    trees = [import_medmamba_state_dict(sd, **cfg)[0]]
    trees += [_mask_tree(name, dict(depths=(1, 1), dims=(16, 32)), 8)
              for name in SSD16_HEADS]
    for got in trees:
        want = jax_no_weight_decay_mask(got)
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_g) == len(flat_w)
        for (key, g), (_, w) in zip(flat_g, flat_w):
            g = np.asarray(g)
            assert g.min() == g.max() == float(w), jax.tree_util.keystr(key)
    kans = dict(no_weight_decay_mask(create_model(
        "medssd_3kan", 3, ssd_headdim=8, depths=(1, 1), dims=(16, 32))))
    assert not kans["kans.bn.weight"] and kans["kans.kan1.coef"]


def test_unknown_names_raise():
    p = [("w", torch.nn.Parameter(torch.zeros(2)))]
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adamax", p)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("poly")
