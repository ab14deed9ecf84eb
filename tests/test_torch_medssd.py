"""A reduced MedSSD built in the JAX package and carried into the port:
eval logits, a 5-step Adam trajectory, the init distributions, and the
state_dict keys through the JAX importer.

The reduced model keeps MedSSD's structure at 32x32 with narrow widths
(dims 32..256, d_state 32, headdim 8, chunk 16).  With the dirs window
widened to l >= 8 on both sides, as the JAX package's tests do, stage 0
(L 64) takes the fused dirs path at chunk 16 (the port's plain twin, the
JAX kernel in Pallas interpret mode), stage 1 (L 16) at chunk 8, and
stages 2-3 the einsum path.  At 68x68, with the single-layout fused SSD's
and Y_diag's windows widened too, stage 0 (L 289) takes the single-layout
fused SSD over a padded last chunk and stage 3 Y_diag, as MedSSD at
240x240 takes them at its stages 1 and 2."""

import jax
import numpy as np
import optax
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.kernels.ssd_fused_pallas as jsf
import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_fused as tsf
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu.train.train_state import (
    TrainState as JaxTrainState,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_medssd_state_dict,
)
from medical_image_classification_tpu_torch.kernels import ssd_fused_dirs
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.models.ss2d_modules import SS2DSSD
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
    medssd_state_dict_from_jax,
)

torch.set_num_threads(2)

CFG = dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256), d_state=32,
           ssd_headdim=8, ssd_chunk_size=16)
IMPORT_CFG = dict(depths=CFG["depths"], dims=CFG["dims"], headdim=8)
NUM_CLASSES, BATCH, SIZE = 8, 4, 32
# the JAX leaves moved away from init (norm scales and biases, and the
# SSD parameters: at init D = 1 and Δ is small)
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight")


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    monkeypatch.setattr(jsfd, "_INTERPRET", True)
    monkeypatch.setattr(jsfd, "_MIN_L", 8)
    monkeypatch.setattr(tssd, "_MIN_L", 8)


@pytest.fixture(scope="module")
def jax_model_and_weights():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsfd, "_INTERPRET", True)
        mp.setattr(jsfd, "_MIN_L", 8)
        model = jax_create("medssd", num_classes=NUM_CLASSES,
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
        to_np(variables["batch_stats"])


def _port(params, stats, **kw):
    model = create_model("medssd", NUM_CLASSES, drop_path_rate=0.0, **CFG,
                         **kw)
    model.load_state_dict(medssd_state_dict_from_jax(params, stats),
                          strict=True)
    return model


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, NUM_CLASSES, (BATCH,), dtype=np.int32))
            for _ in range(n)]


def test_stage_paths():
    """The reduced model's stages take the paths the module docstring
    names (the same gate picks the full model's 224 / 196 / - / -)."""
    got = [tssd.ssd_dirs_chunk(L, 16, 128, 8, 4 * d // 8, d)
           for L, d in ((64, 32), (16, 64), (4, 128), (1, 256))]
    assert got == [16, 8, None, None]


def test_eval_logits_match_jax(jax_model_and_weights):
    """Logits within 2e-3 x max|logit| (fp32; the dirs twin, the einsum
    path and the norms sum in other orders than XLA)."""
    model, params, stats = jax_model_and_weights
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.sgd(1e-3))
    imgs, labels = _batches(1, 1)[0]
    n_j, logits_j = jax_make_eval_step(model)(state, imgs, labels)
    port = _port(params, stats)
    before = ssd_fused_dirs.ssd_fused_dirs_fwd.launches
    n_t, logits_t = make_eval_step(port)(torch.from_numpy(imgs),
                                         torch.from_numpy(labels).long())
    assert ssd_fused_dirs.ssd_fused_dirs_fwd.launches == before  # plain
    assert logits_t.dtype == torch.float32
    assert logits_t.shape == (BATCH, NUM_CLASSES)
    logits_j = np.asarray(logits_j)
    scale = float(np.abs(logits_j).max())
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                               atol=2e-3 * scale)
    assert int(n_t) == int(n_j)


def test_adam_trajectory_matches_jax(jax_model_and_weights):
    """Adam at lr 1e-4, a new batch each step, 5 steps, DropPath off: the
    per-step losses within rtol 1e-2 (the ladder of the MedMamba
    trajectory test: Adam divides by sqrt(v), so fp32 gradient noise near
    zero grows over the steps), and every parameter moved but stage 3's
    A_logs: at L = 1 the state carries nothing into y, so A's gradient is
    exactly zero (on the JAX side too)."""
    model, params, stats = jax_model_and_weights
    batches = _batches(2, 5)
    state = JaxTrainState.create(params, {"batch_stats": stats},
                                 optax.adam(1e-4))
    step_j = jax_make_train_step(model, donate=False)
    losses_j = []
    for imgs, labels in batches:
        state, metrics = step_j(state, imgs, labels, jax.random.PRNGKey(0))
        losses_j.append(float(metrics["loss"]))

    port = _port(params, stats)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = make_optimizer("adam", port.named_parameters())
    step = make_train_step(port, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-4)), state=TrainState())
    losses_t = [float(step(torch.from_numpy(i),
                           torch.from_numpy(l).long())["loss"])
                for i, l in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2, atol=2e-4)
    still = [n for n, p in port.named_parameters()
             if torch.equal(p, before[n])]
    assert still == ["layers.3.blocks.0.self_attention.A_logs"], still


def test_state_dict_roundtrips_through_jax_importer(jax_model_and_weights):
    _, params, stats = jax_model_and_weights
    params2, stats2 = import_medssd_state_dict(
        _port(params, stats).state_dict(), **IMPORT_CFG)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    for want, got in ((flat(params), flat(params2)),
                      (flat(stats), flat(stats2))):
        assert set(want) == set(got), set(want) ^ set(got)
        for k in want:
            assert want[k].shape == got[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_distributions_match_jax():
    """The port's seeded init draws from the JAX package's distributions:
    constant leaves are equal, random leaves agree in mean and spread, and
    A_logs / dt_bias repeat one draw over the four directions."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsfd, "_INTERPRET", True)
        mp.setattr(jsfd, "_MIN_L", 8)
        model = jax_create("medssd", num_classes=NUM_CLASSES, **CFG)
        ref = jax.jit(model.init)({"params": jax.random.PRNGKey(4)},
                                  np.zeros((1, SIZE, SIZE, 3), np.float32))
    port = create_model("medssd", NUM_CLASSES,
                        generator=torch.Generator().manual_seed(4), **CFG)
    got, got_stats = import_medssd_state_dict(port.state_dict(),
                                              **IMPORT_CFG)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v
                in jax.tree_util.tree_flatten_with_path(dict(tree))[0]}

    pooled = {}
    for want_tree, got_tree in ((ref["params"], got),
                                (ref["batch_stats"], got_stats)):
        want_f, got_f = flat(want_tree), flat(got_tree)
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
            else:                 # small SSD leaves: pooled over blocks
                name = k.rsplit("'", 2)[-2]
                pw, pg = pooled.setdefault(name, ([], []))
                pw.append(w.ravel())
                pg.append(g.ravel())
    for name in ("A_logs", "dt_bias"):
        w = np.concatenate(pooled[name][0])
        g = np.concatenate(pooled[name][1])
        n = len(np.unique(w))
        assert abs(g.std() / w.std() - 1) < 5 / np.sqrt(n), name
        assert abs(g.mean() - w.mean()) < 5 * w.std() * np.sqrt(2 / n), name
    for m in port.modules():
        if isinstance(m, SS2DSSD):
            a = m.A_logs.detach().view(4, -1)
            assert torch.equal(a, a[:1].expand_as(a))
            assert torch.equal(m.dt_bias, m.dt_bias[:1].expand_as(m.dt_bias))
            assert bool(((a >= 0) & (a <= np.log(16.0) + 1e-6)).all())


def test_bf16_compute_and_unported_options():
    """dtype=bf16 runs with fp32 parameters and gives logits close to fp32
    (0.1 x max|logit|: bf16 activations through 5 blocks); SS2DSSD takes
    the KAN projections, and neither it nor the model takes the JAX
    dropouts (0 in every model, not ported)."""
    port = create_model("medssd", NUM_CLASSES, drop_path_rate=0.0,
                        generator=torch.Generator().manual_seed(2), **CFG)
    port16 = create_model("medssd", NUM_CLASSES, drop_path_rate=0.0,
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
    with pytest.raises(TypeError, match="unexpected keyword"):
        SS2DSSD(16, d_state=8, headdim=8, dropout=0.1)
    for kw in (dict(drop_rate=0.1), dict(attn_drop_rate=0.1)):
        with pytest.raises(TypeError, match="unexpected keyword"):
            create_model("medssd", NUM_CLASSES, **CFG, **kw)
    # the KAN projections are ported: kan_in replaces in_proj, kan_filter
    # goes in front of it; both are deterministic in train mode
    u = torch.randn(2, 4, 4, 16)
    for kw, names in ((dict(kan_in=True), ("in_proj_kan",)),
                      (dict(kan_filter=True), ("filter_kan", "in_proj"))):
        sa = SS2DSSD(16, d_state=8, headdim=8, chunk_size=8, **kw)
        assert all(getattr(sa, n) is not None for n in names), kw
        assert (sa.in_proj is None) == ("in_proj" not in names), kw
        nn_init = torch.Generator().manual_seed(0)
        for p in sa.parameters():
            torch.nn.init.normal_(p, 0.0, 0.1, generator=nn_init)
        with torch.no_grad():
            y_eval = sa.eval()(u)
            y_train = sa.train()(u)
        assert y_eval.shape == (2, 4, 4, 16)
        assert torch.equal(y_eval, y_train), kw


PADDED_SIZE, PADDED_BATCH = 68, 2       # sides 17, 8, 4, 2


def _widen_all(mp):
    """The fused SSD's and Y_diag's windows widened to l >= 8 on both sides
    (the dirs window already is), their JAX kernels in interpret mode."""
    for mod in (jsf, jyd):
        mp.setattr(mod, "_INTERPRET", True)
    for mod in (jsf, jyd, tsf, tyd):
        mp.setattr(mod, "_MIN_L", 8)


def test_stage_paths_at_68():
    """At 68x68: stage 0 (L 289 = 17^2) has no pad-free dirs chunk, so it
    takes the single-layout fused SSD at chunk 16, the 19th chunk padded
    (289 -> 304); stages 1-2 (L 64, 16) the dirs path; stage 3 (L 4) one
    chunk of 8, too few for the fused SSD, so Y_diag."""
    with pytest.MonkeyPatch.context() as mp:
        _widen_all(mp)
        dirs = [tssd.ssd_dirs_chunk(L, 16, 128, 8, 4 * d // 8, d)
                for L, d in ((289, 32), (64, 64), (16, 128), (4, 256))]
        assert dirs == [None, 16, 8, None]
        assert [tssd._pick_chunk(L, 16, 128) for L in (289, 4)] == [16, 8]
        assert tsf.ssd_fused_supported(16, 128, 8, 1, 19)
        assert not tsf.ssd_fused_supported(8, 128, 8, 1, 1)
        assert tyd.ydiag_supported(8, 128, 8, 1)


def test_fused_and_ydiag_stages_match_jax(jax_model_and_weights):
    """The reduced model at 68x68 through the single-layout fused SSD
    (stage 0, padded) and Y_diag (stage 3), both sides: fp32 eval logits
    within 2e-3 x max|logit|, and two Adam steps at lr 1e-4 (the second
    loss sees the first step's update) within the trajectory test's rtol
    1e-2; each path's plain version ran once per forward."""
    model, params, stats = jax_model_and_weights
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 256, (PADDED_BATCH, PADDED_SIZE,
                                      PADDED_SIZE, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, (PADDED_BATCH,), dtype=np.int32))
               for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        _widen_all(mp)
        calls = []
        for mod, name in ((tsf, "ssd_fused_fwd_ref"),
                          (tyd, "ydiag_fused_ref")):
            orig = getattr(mod, name)
            mp.setattr(mod, name, lambda *a, _o=orig, _n=name, **k:
                       calls.append(_n) or _o(*a, **k))
        imgs, labels = batches[0]
        state = JaxTrainState.create(params, {"batch_stats": stats},
                                     optax.adam(1e-4))
        _, logits_j = jax_make_eval_step(model)(state, imgs, labels)
        port = _port(params, stats)
        _, logits_t = make_eval_step(port)(torch.from_numpy(imgs),
                                           torch.from_numpy(labels).long())
        assert calls == ["ssd_fused_fwd_ref", "ydiag_fused_ref"]
        logits_j = np.asarray(logits_j)
        np.testing.assert_allclose(
            logits_t.numpy(), logits_j, rtol=0,
            atol=2e-3 * float(np.abs(logits_j).max()))

        step_j = jax_make_train_step(model, donate=False)
        losses_j = []
        for imgs, labels in batches[1:]:
            state, metrics = step_j(state, imgs, labels,
                                    jax.random.PRNGKey(0))
            losses_j.append(float(metrics["loss"]))
        opt = make_optimizer("adam", port.named_parameters())
        step = make_train_step(port, opt, make_lr_scheduler(
            opt, make_schedule("constant", 1e-4)), state=TrainState())
        losses_t = [float(step(torch.from_numpy(i),
                               torch.from_numpy(l).long())["loss"])
                    for i, l in batches[1:]]
        np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2, atol=2e-4)
