"""A reduced MedMamba built in the JAX package and carried into the port:
eval logits agree, and the weights roundtrip through the JAX importer."""

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.train.train_state import (
    TrainState,
    make_eval_step as jax_make_eval_step,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medmamba_state_dict,
)
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.train.eval_step import (
    make_eval_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    medmamba_state_dict_from_jax,
)

torch.set_num_threads(2)

CFG = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), d_state=8)
NUM_CLASSES, BATCH, SIZE = 8, 2, 64


def _perturb(tree, rng, names):
    """Move the leaves called ``names`` away from their init values."""
    def go(node):
        return {k: (go(v) if isinstance(v, dict) else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32) if k in names
                                     else 0.0))
                for k, v in node.items()}
    return go(tree)


@pytest.fixture(scope="module")
def jax_model_and_state():
    model = jax_create("medmamba", num_classes=NUM_CLASSES,
                       drop_path_rate=0.0, **CFG)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           np.zeros((1, SIZE, SIZE, 3), np.float32))
    rng = np.random.default_rng(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    params = _perturb(to_np(variables["params"]), rng, ("bias", "scale"))
    stats = to_np(variables["batch_stats"])
    # BatchNorm running stats away from 0 / 1: eval mode must use them
    stats = jax.tree_util.tree_map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape) if a.min() == 0
                       else 0.5 * rng.random(a.shape)).astype(np.float32),
        stats)
    state = TrainState.create(params, {"batch_stats": stats},
                              optax.sgd(1e-3))
    return model, params, stats, state


def _port_model(params, stats):
    port = create_model("medmamba", NUM_CLASSES, drop_path_rate=0.0, **CFG)
    port.load_state_dict(medmamba_state_dict_from_jax(params, stats),
                         strict=True)
    return port


def _small_variance(params, stats):
    """Shrink the patch-embed conv and the BatchNorm running variances by
    1e-3, so that activation variances come near the norms' eps and a wrong
    eps shows in the logits."""
    params = jax.tree_util.tree_map(np.copy, params)
    proj = params["patch_embed"]["proj"]
    proj["kernel"], proj["bias"] = proj["kernel"] * 1e-3, proj["bias"] * 1e-3
    stats = jax.tree_util.tree_map(
        lambda a: a * 1e-3 if a.min() > 0.2 else a, stats)   # var, not mean
    return params, stats


@pytest.mark.parametrize("regime", ["init_scale", "small_variance"])
def test_eval_logits_match_jax(jax_model_and_state, regime):
    model, params, stats, state = jax_model_and_state
    if regime == "small_variance":
        params, stats = _small_variance(params, stats)
        state = TrainState.create(params, {"batch_stats": stats},
                                  optax.sgd(1e-3))
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, (BATCH,), dtype=np.int32)
    n_j, logits_j = jax_make_eval_step(model)(state, imgs, labels)

    n_t, logits_t = make_eval_step(_port_model(params, stats))(
        torch.from_numpy(imgs), torch.from_numpy(labels).long())
    assert logits_t.dtype == torch.float32
    assert logits_t.shape == (BATCH, NUM_CLASSES)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(logits_t.numpy().argmax(-1),
                                  np.asarray(logits_j).argmax(-1))
    assert int(n_t) == int(n_j)


def test_state_dict_roundtrips_through_jax_importer(jax_model_and_state):
    _, params, stats, _ = jax_model_and_state
    port = _port_model(params, stats)
    params2, stats2 = import_medmamba_state_dict(port.state_dict(), **CFG)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    for want, got in ((flat(params), flat(params2)),
                      (flat(stats), flat(stats2))):
        assert set(want) == set(got), set(want) ^ set(got)
        for k in want:
            assert want[k].shape == got[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_norm_settings_match_flax():
    """Flax's LayerNorm eps is 1e-6 (torch's default 1e-5); BatchNorm eps
    1e-5 and Flax momentum 0.9 (torch 0.1)."""
    port = create_model("medmamba", NUM_CLASSES, **CFG)
    lns = [m for m in port.modules() if isinstance(m, torch.nn.LayerNorm)]
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    # patch_embed + per block (ln_1, out_norm) + per downsample
    assert len(lns) == 1 + 2 * sum(CFG["depths"]) + len(CFG["depths"]) - 1
    assert len(bns) == 3 * sum(CFG["depths"])
    assert all(m.eps == 1e-6 for m in lns)
    assert all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)


def test_bf16_compute_keeps_fp32_params(jax_model_and_state):
    """dtype=bf16 runs the model in bf16 with fp32 parameters and returns
    fp32 logits close to the fp32 run."""
    _, params, stats, _ = jax_model_and_state
    port = _port_model(params, stats)
    port16 = create_model("medmamba", NUM_CLASSES, drop_path_rate=0.0,
                          dtype=torch.bfloat16, **CFG)
    port16.load_state_dict(port.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    x = torch.from_numpy(np.random.default_rng(2).random(
        (BATCH, SIZE, SIZE, 3), dtype=np.float32))
    with torch.inference_mode():
        y32, y16 = port.eval()(x), port16.eval()(x)
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    scale = float(y32.abs().max())
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=0.1,
                               atol=0.1 * scale)


def test_seeded_init_is_reproducible_and_unported_names_raise():
    a = create_model("medmamba", 4, generator=torch.Generator().manual_seed(3),
                     **CFG)
    b = create_model("medmamba", 4, generator=torch.Generator().manual_seed(3),
                     **CFG)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sa = a.layers[0].blocks[0].self_attention
    assert torch.equal(sa.A_logs[0], torch.log(torch.arange(1.0, 9.0)))
    assert torch.equal(sa.Ds, torch.ones_like(sa.Ds))
    with pytest.raises(KeyError, match="not ported"):
        create_model("cnn_mamba", 4)
    with pytest.raises(NotImplementedError):
        create_model("medmamba", 4, head="ekan", **CFG)


def test_init_distributions_match_jax():
    """The port's seeded init draws from the JAX package's distributions:
    constant leaves are equal, random leaves agree in mean and spread."""
    model = jax_create("medmamba", num_classes=NUM_CLASSES, **CFG)
    ref = model.init({"params": jax.random.PRNGKey(4)},
                     np.zeros((1, SIZE, SIZE, 3), np.float32))
    port = create_model("medmamba", NUM_CLASSES,
                        generator=torch.Generator().manual_seed(4), **CFG)
    got, got_stats = import_medmamba_state_dict(port.state_dict(), **CFG)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v
                in jax.tree_util.tree_flatten_with_path(dict(tree))[0]}

    for want_tree, got_tree in ((ref["params"], got),
                                (ref["batch_stats"], got_stats)):
        want_f, got_f = flat(want_tree), flat(got_tree)
        assert set(want_f) == set(got_f)
        for k, w in want_f.items():
            g = got_f[k]
            if w.std() == 0:
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif w.size >= 256:
                # 5-sigma bounds for two samples of n independent draws
                # (the Δ-bias repeats one draw across the 4 directions)
                n = len(np.unique(w))
                assert abs(g.std() / w.std() - 1) < 5 / np.sqrt(n), k
                assert abs(g.mean() - w.mean()) < \
                    5 * w.std() * np.sqrt(2 / n), k


def test_channel_shuffle_and_drop_path():
    """channel_shuffle matches the JAX function and the block's interleave;
    DropPath is the identity in eval and keeps or zeroes whole samples
    (scaled by 1/keep) in training."""
    from medical_image_classification_tpu.models.common import (
        channel_shuffle as jax_channel_shuffle)
    from medical_image_classification_tpu_torch.models.common import (
        DropPath, channel_shuffle)
    x = np.random.default_rng(3).standard_normal((2, 3, 3, 8)).astype(
        np.float32)
    got = channel_shuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_channel_shuffle(x, 2)))
    l, r = torch.from_numpy(x).chunk(2, dim=-1)
    assert torch.equal(got, torch.stack([l, r], -1).reshape(2, 3, 3, 8))

    dp = DropPath(0.5)
    t = torch.ones(64, 2, 2, 3)
    assert dp.eval()(t) is t
    out = dp.train()(t)
    per_sample = out.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert bool((per_sample == per_sample[:, :1]).all())
