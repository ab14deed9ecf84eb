"""The fusion U-Nets of the port (``FusionVFEFM``: vfefm_2b2, and
vfefm_2c1 with ``single_decoder``) against the JAX package's, fp32, drop
path off: at ``FUSION_SMALL`` (``tests/test_crossmamba.py:51``: two
stages, dims 8 and 16, d_state 4, headdim 4; the fusions at d_state 128)
at 32x32 with both decoders, and the four-stage wiring (dims 8..64) at
64x64 with the dual decoder.

The port's seeded weights, drawn away from init, go to JAX through
``import_vfefm_state_dict``; inputs from a numpy seed, batch 2 (the fusion
trainer's).  One jitted JAX program per configuration gives the eval
fused image and, in train mode (batch statistics), the gradient of
mean(out * w) for a seeded w.  The fused image within 2e-3 x max|ref|
(rtol 0); every parameter's gradient within leaf rel-norm 2e-2 and cosine
0.998; the carrier (``vfefm_state_dict_from_jax``, the scanned block pairs
unstacked) is the importer's exact inverse."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_classification_tpu.models.crossmamba import (
    FusionVFEFM as JaxFusionVFEFM,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_vfefm_state_dict,
)
from medical_image_classification_tpu_torch.models import create_fusion_model
from medical_image_classification_tpu_torch.train.eval_step import (
    make_fusion_eval_step,
)
from medical_image_classification_tpu_torch.utils.weights import (
    vfefm_state_dict_from_jax,
)
from test_torch_crossmamba import (
    assert_scaled,
    flat_shapes,
    grads_close,
    perturb_,
)

torch.set_num_threads(2)

FUSION_SMALL = dict(depths=(1, 1), dims=(8, 16), depths_decoder=(1, 1),
                    dims_decoder=(16, 8), d_state=4, ssd_headdim=4)
FOUR_STAGE = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                  depths_decoder=(1, 1, 1, 1), dims_decoder=(64, 32, 16, 8),
                  d_state=4, ssd_headdim=4)
# (registry name, config, image side)
CASES = {"2b2": ("vfefm_2b2", FUSION_SMALL, 32),
         "2c1": ("vfefm_2c1", FUSION_SMALL, 32),
         "2b2-four-stage": ("vfefm_2b2", FOUR_STAGE, 64)}
BATCH = 2


def _port(case):
    name, cfg, _ = CASES[case]
    return perturb_(create_fusion_model(name, drop_path_rate=0.0, **cfg), 3)


def _jax_vars(state_dict, case):
    name, cfg, _ = CASES[case]
    return import_vfefm_state_dict(
        {k: v.numpy() for k, v in state_dict.items()}, depths=cfg["depths"],
        depths_decoder=cfg["depths_decoder"], dims=cfg["dims"],
        headdim=cfg["ssd_headdim"], single_decoder=name == "vfefm_2c1")


def _jax_model(case):
    name, cfg, _ = CASES[case]
    return JaxFusionVFEFM(single_decoder=name == "vfefm_2c1",
                          drop_path_rate=0.0, **cfg)


def _inputs(case, seed):
    side = CASES[case][2]
    rng = np.random.default_rng(seed)
    return [rng.random((BATCH, side, side, 3), dtype=np.float32)
            for _ in range(2)] + [rng.standard_normal(
                (BATCH, side, side, 1), dtype=np.float32)]


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    params, stats = _jax_vars(_port(case).state_dict(), case)
    model = _jax_model(case)
    (ea, eb, _), (ta, tb, w) = _inputs(case, 1), _inputs(case, 2)

    def run(params):
        out = model.apply({"params": params, "batch_stats": stats}, ea, eb,
                          train=False)

        def loss_fn(p):
            # the scanned blocks take their drop-path rate as a traced
            # input, so they ask for a key even at rate 0 (all kept)
            y, _ = model.apply({"params": p, "batch_stats": stats}, ta, tb,
                               train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.mean(y * w)

        return out, jax.value_and_grad(loss_fn)(params)

    out, (loss, grads) = jax.jit(run)(params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np.asarray(out), float(loss), to_np(grads), stats


@pytest.mark.parametrize("case", list(CASES))
def test_fusion_unet_matches_jax(case):
    """The fused image (eval, the raw output and the clamped one of the
    eval step), then the train-mode loss and every parameter's gradient."""
    out_j, loss_j, grads_j, stats = _jax_results(case)
    port = _port(case)
    ea, eb, _ = (torch.from_numpy(a) for a in _inputs(case, 1))
    with torch.no_grad():
        out = port.eval()(ea, eb)
    assert out.dtype == torch.float32 and out.shape == out_j.shape
    assert_scaled(out.numpy(), out_j)
    np.testing.assert_allclose(make_fusion_eval_step(port)(ea, eb).numpy(),
                               np.clip(out.numpy(), 0, 1), rtol=0, atol=0)
    ta, tb, w = (torch.from_numpy(a) for a in _inputs(case, 2))
    port.train()
    loss = (port(ta, tb) * w).mean()
    loss.backward()
    assert abs(float(loss.detach()) - loss_j) <= 2e-3 * abs(loss_j)
    name = CASES[case][0]
    want = vfefm_state_dict_from_jax(grads_j, stats, name == "vfefm_2c1")
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    grads_close(got, {n: want[n].numpy() for n in got})


@pytest.mark.parametrize("case", list(CASES))
def test_fusion_unet_carrier_round_trip(case):
    """Port state_dict -> JAX importer -> carrier: every tensor back bit for
    bit, a strict load; the importer's trees (block pairs stacked [depth,
    2, ...]) have the JAX model's structure and shapes."""
    name = CASES[case][0]
    sd = _port(case).state_dict()
    params, stats = _jax_vars(sd, case)
    back = vfefm_state_dict_from_jax(params, stats, name == "vfefm_2c1")
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k
    _port(case).load_state_dict(back, strict=True)
    side = CASES[case][2]
    x = jnp.zeros((1, side, side, 3))
    shapes = jax.eval_shape(
        lambda: _jax_model(case).init(jax.random.PRNGKey(0), x, x))
    assert flat_shapes(shapes["params"]) == flat_shapes(params)
    assert flat_shapes(shapes["batch_stats"]) == flat_shapes(stats)


@pytest.mark.parametrize("case", ["2b2", "2c1"])
def test_fusion_unet_bf16_compute(case):
    """bf16 compute, fp32 parameters: the fused image comes back fp32,
    finite, and tracks the fp32 one (the JAX test's bounds)."""
    name, cfg, side = CASES[case]
    port = _port(case)
    bf16 = create_fusion_model(name, drop_path_rate=0.0, dtype=torch.bfloat16,
                               **cfg)
    bf16.load_state_dict(port.state_dict())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    ea, eb, _ = (torch.from_numpy(a) for a in _inputs(case, 1))
    with torch.no_grad():
        a = port.eval()(ea, eb).numpy().ravel()
        b = bf16.eval()(ea, eb)
    assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    b = b.numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.99
    assert float(np.mean(np.abs(a - b))) < 0.1 * (float(np.std(a)) + 1e-6)


def test_chip_smoke_conditioned_gradient_gate():
    """chip_smoke.py's gate for the U-Nets' fp32 gradients, both fp32
    paths against the float64 gradient: on every leaf the kernels' rel-norm
    error at most PARAM_GRAD_TOL's plus COND_RATIO x the plain twins' own.
    A leaf where the plain twins miss by 3% passes at 6% and fails at 12%;
    where they are exact the plain tolerance holds (3% fails); a leaf
    turned against its reference fails; leaves under the abs floor
    pass, and a gate whose leaves all lie under it raises."""
    import chip_smoke
    rng = np.random.default_rng(0)
    exact = {f"leaf{i}": torch.from_numpy(rng.standard_normal(64))
             for i in range(4)}

    def off(rel, seed):
        r = np.random.default_rng(seed)
        return {k: v + rel[i] * v.norm() / 8 * torch.from_numpy(
                    r.standard_normal(64))
                for i, (k, v) in enumerate(exact.items())}

    tol = chip_smoke.PARAM_GRAD_TOL
    assert chip_smoke.COND_RATIO == 2.0
    check = chip_smoke._check_grad_tree_exact
    plain = off([0.03, 0.001, 0.0, 0.0], 1)
    rel, cos, st = check("t", off([0.06, 0.01, 0.0, 0.0], 2), plain, exact,
                         *tol)
    assert 0.04 < rel < 0.08 and st["kernels"]["leaves_over_tol"] == 1
    assert st["plain"]["leaves_over_tol"] == 1
    assert 0.02 < st["plain"]["worst_rel"] < 0.04
    for bad in ([0.12, 0.0, 0.0, 0.0], [0.0, 0.0, 0.03, 0.0],
                [0.0, 0.0, 0.0, 0.5]):
        with pytest.raises(AssertionError, match="leaves beyond"):
            check("t", off(bad, 3), plain, exact, *tol)
    flipped = dict(exact, leaf3=-exact["leaf3"])
    with pytest.raises(AssertionError, match="leaves beyond"):
        check("t", flipped, plain, exact, *tol)
    tiny = dict(exact, leaf3=exact["leaf3"] * 1e-6)
    check("t", dict(off([0.01, 0.0, 0.0, 0.0], 2), leaf3=-tiny["leaf3"]),
          dict(plain, leaf3=tiny["leaf3"]), tiny, *tol)
    with pytest.raises(AssertionError, match="checks none"):
        check("t", dict(exact, leaf3=-tiny["leaf3"]), exact,
              dict(exact, leaf3=tiny["leaf3"]), *tol)


@pytest.mark.parametrize("name", ["vfefm_2b2", "vfefm_2c1"])
def test_float64_takes_the_plain_einsums(monkeypatch, name):
    """The float64 reference of chip_smoke.py's gradient gate: the model
    and inputs in float64 reach neither a kernel nor a plain twin (the
    dirs SSD, Y_diag, the fused SSD; their windows widened to this size),
    stay float64 to the fused image and every gradient, and agree with the
    fp32 plain path (which reaches the dirs and Y_diag twins here) within
    the file's tolerances."""
    import medical_image_classification_tpu_torch.kernels.ssd as tssd
    import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
    calls = []
    for fn in ("ssd_fused_dirs", "ydiag_fused", "ssd_fused"):
        orig = getattr(tssd, fn)
        monkeypatch.setattr(tssd, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.append((_n, a[0].dtype)), _f(*a, **k))[1])
    monkeypatch.setattr(tssd, "_MIN_L", 8)
    monkeypatch.setattr(tyd, "_MIN_L", 8)
    cfg = dict(FUSION_SMALL, ssd_headdim=8)     # P 8: the twins' shapes
    port = perturb_(create_fusion_model(name, drop_path_rate=0.0,
                                        scan_impl="torch", **cfg), 3).train()
    ta, tb, w = (torch.from_numpy(a) for a in _inputs("2b2", 2))
    outs, grads = {}, {}
    for dt in (torch.float32, torch.float64):
        calls.clear()
        model = port.to(dt)
        model.zero_grad(set_to_none=True)
        outs[dt] = model(ta.to(dt), tb.to(dt))
        (outs[dt] * w.to(dt)).mean().backward()
        grads[dt] = {n: p.grad for n, p in model.named_parameters()}
        assert outs[dt].dtype == dt
        assert all(g.dtype == dt for g in grads[dt].values())
        if dt == torch.float64:
            assert calls == []
        else:
            assert {n for n, _ in calls} >= {"ssd_fused_dirs", "ydiag_fused"}
    assert_scaled(outs[torch.float32].detach().numpy(),
                  outs[torch.float64].detach().numpy())
    grads_close({n: g.numpy() for n, g in grads[torch.float32].items()},
                {n: g.numpy() for n, g in grads[torch.float64].items()})
