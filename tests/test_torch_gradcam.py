"""The port's Grad-CAM against the JAX package's, on reduced models carried
over from the JAX init: each stage's activation and the gradient of the
target logits with respect to it (as ``gradcam.py:38-56`` computes them:
the ``stage_out`` intermediates and ``jax.grad`` over the ``perturbations``
collection), fp32, within 1e-4 x max|.|; then the heatmaps within 1e-4
absolute, each stage's map spanning more than 1e-3 (the min-max scaling
divides by it).  Reduced medmamba (depths 1-1, dims 16/32, d_state 4, as
``tests/test_gradcam_data.py``), medssd (dims 32/64, d_state 32, headdim
8, chunk 16: the dirs kernels' window widened to l >= 8 on both sides, the
JAX kernel in interpret mode) and st_ssd (as ``tests/test_torch_st_ssd.py``:
Y_diag, the STL mixer and the STF gate widened on both sides) at 32x32.
Also: the bilinear resize against ``jax.image.resize``, ``overlay_heatmap``
bit for bit, no parameter or buffer changed by a call, ``cli/cam.py``, and
chip_smoke.py's Grad-CAM launches pinned from a meta forward."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_classification_tpu.kernels.ssd_fused_dirs_pallas as jsfd
import medical_image_classification_tpu.kernels.ssd_ydiag_pallas as jyd
import medical_image_classification_tpu.kernels.stf_zgate_pallas as jszp
import medical_image_classification_tpu.kernels.stl_mixer_pallas as jsmp
import medical_image_classification_tpu_torch.kernels.ssd as tssd
import medical_image_classification_tpu_torch.kernels.ssd_ydiag as tyd
import medical_image_classification_tpu_torch.kernels.stf_zgate as tszp
import medical_image_classification_tpu_torch.kernels.stl_mixer as tsmp
from medical_image_classification_tpu.data.image_folder import (
    normalize_batch as jax_normalize,
)
from medical_image_classification_tpu.evaluate import gradcam as jgc
from medical_image_classification_tpu.models import create_model as jax_create
from medical_image_classification_tpu_torch.evaluate import gradcam as tgc
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.utils import weights as tw

torch.set_num_threads(1)

SIZE, BATCH, CLASSES = 32, 2, 4
CFG = {
    "medmamba": dict(depths=(1, 1), dims=(16, 32), d_state=4),
    "medssd": dict(depths=(1, 1), dims=(32, 64), d_state=32, ssd_headdim=8,
                   ssd_chunk_size=16),
    "st_ssd": dict(depths=(1, 1), dims=(128, 256), d_state=16,
                   ssd_headdim=32, st_tokens=(8, 4)),
}
CARRIER = {"medmamba": tw.medmamba_state_dict_from_jax,
           "medssd": tw.medssd_state_dict_from_jax,
           "st_ssd": tw.st_ssd_state_dict_from_jax}
PERTURB = ("bias", "scale", "A_logs", "dt_bias", "Ds", "norm_weight",
           "k_weights", "mean")
# the head's kernel scaled up from its init (trunc-normal 0.02): logits of
# a trained head's size, and so stage maps that span well over 1e-3
HEAD_SCALE = 100.0


def _widen(mp):
    """Every kernel gate of the reduced models opened on both sides, the
    JAX kernels in interpret mode."""
    for mod in (jsfd, jyd, jsmp, jszp):
        mp.setattr(mod, "_INTERPRET", True)
    for mod in (jsfd, tssd, jyd, tyd):
        mp.setattr(mod, "_MIN_L", 8)
    for mod in (jsmp, tsmp):
        mp.setattr(mod, "_MIN_LP", 8 * 8)
    for mod in (jszp, tszp):
        mp.setattr(mod, "_MIN_PP", 8 * 8)


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    _widen(monkeypatch)


def _images(seed, n=BATCH, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


class _Jitted:
    """A JAX model whose ``apply`` (eval, with or without the intermediates)
    is jitted: JAX's ``grad_cam`` calls ``apply`` eagerly, which runs the
    interpret-mode kernels op by op."""

    def __init__(self, model):
        self._apply = {
            bool(m): jax.jit(functools.partial(model.apply, train=False,
                                               **m))
            for m in ({}, {"mutable": ["intermediates"]})}

    def apply(self, variables, x, train=False, mutable=None):
        assert not train
        return self._apply[bool(mutable)](variables, x)


def _pair(name):
    """The JAX model (``apply`` jitted) and variables (its init with norms,
    biases and the SSD parameters moved away from it) and the port model
    carrying them."""
    model = jax_create(name, num_classes=CLASSES, drop_path_rate=0.0,
                       **CFG[name])
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                    np.zeros((1, SIZE, SIZE, 3), np.float32))
    rng = np.random.default_rng(0)

    def perturb(node):
        return {k: (perturb(v) if isinstance(v, dict) else
                    np.asarray(v) + (0.2 * rng.standard_normal(np.shape(v))
                                     .astype(np.float32)
                                     if k in PERTURB else 0.0))
                for k, v in node.items()}

    params = perturb(jax.tree_util.tree_map(np.asarray,
                                            dict(variables["params"])))
    head = params["classifier"]["head"]
    head["kernel"] = head["kernel"] * HEAD_SCALE
    stats = perturb(jax.tree_util.tree_map(np.asarray,
                                           dict(variables["batch_stats"])))
    port = create_model(name, CLASSES, drop_path_rate=0.0, **CFG[name])
    port.load_state_dict(CARRIER[name](params, stats), strict=True)
    return _Jitted(model), {"params": params, "batch_stats": stats}, port


def _jax_stage_grads(model, variables, images_u8):
    """``gradcam.py:38-56``: the stage activations from the intermediates,
    their gradients through zero perturbations; targets the argmax."""
    imgs = jax_normalize(jnp.asarray(images_u8))
    logits, inter = model.apply(variables, imgs, train=False,
                                mutable=["intermediates"])
    targets = jnp.argmax(logits, axis=-1)
    acts = {n: v["stage_out"][0] for n, v in inter["intermediates"].items()}
    perturbs = {n: {"stage_perturb": jnp.zeros_like(a)}
                for n, a in acts.items()}

    def score(p):
        out = model.apply({**variables, "perturbations": p}, imgs,
                          train=False)
        return jnp.sum(out[jnp.arange(imgs.shape[0]), targets])

    grads = jax.grad(score)(perturbs)
    return ({n: np.asarray(a) for n, a in acts.items()},
            {n: np.asarray(g["stage_perturb"]) for n, g in grads.items()},
            np.asarray(targets))


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", ["medmamba", "medssd", "st_ssd"])
def test_stage_grads_and_heatmaps_match_jax(name):
    model, variables, port = _pair(name)
    imgs = _images(1)
    j_acts, j_grads, j_targets = _jax_stage_grads(model, variables, imgs)
    acts, grads, targets = tgc.stage_grads(port, imgs)
    assert list(acts) == sorted(j_acts) == ["layers_0", "layers_1"]
    np.testing.assert_array_equal(targets.numpy(), j_targets)
    for n in acts:
        assert acts[n].shape == j_acts[n].shape, n
        _close(acts[n], j_acts[n], 1e-4, f"{name} {n} activation")
        _close(grads[n], j_grads[n], 1e-4, f"{name} {n} gradient")
        cam = tgc.resize_bilinear(tgc.stage_cam(acts[n], grads[n]),
                                  (SIZE, SIZE))
        span = cam.amax(dim=(1, 2)) - cam.amin(dim=(1, 2))
        assert float(span.min()) > 1e-3, (n, span)
    want = jgc.grad_cam(model, variables, imgs)
    got = tgc.grad_cam(port, imgs)
    assert got.shape == (BATCH, SIZE, SIZE) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # stages picked by name, in the order given (JAX iterates them so)
    sub = ["layers_1", "layers_0"]
    np.testing.assert_allclose(
        tgc.grad_cam(port, imgs, targets=[1, 2], stages=sub),
        jgc.grad_cam(model, variables, imgs, targets=jnp.asarray([1, 2]),
                     stages=sub), rtol=0, atol=1e-4)


def test_grad_cam_changes_no_parameter_or_buffer():
    """A call leaves every parameter, buffer and gradient as it found them,
    restores train mode, and the taps change neither the forward nor the
    state_dict; an unknown stage name raises."""
    port = create_model("medmamba", CLASSES, **CFG["medmamba"])
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.inference_mode():            # no way to zero the hooks
        cam = tgc.grad_cam(port, _images(2), stages=["layers_1"])
    assert np.isfinite(cam).all() and cam.std() > 0
    assert port.training
    after = port.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(p.grad is None for p in port.parameters())
    port.eval()
    x = torch.from_numpy(_images(3)).float() / 127.5 - 1.0
    with torch.no_grad():
        plain = port(x)
        with port.stage_outputs() as acts:
            tapped = port(x)
    assert torch.equal(plain, tapped) and list(acts) == port.stage_names()
    with pytest.raises(ValueError, match="unknown stages"):
        tgc.grad_cam(port, _images(2), stages=["layers_2"])


@pytest.mark.parametrize("h,w,H,W", [(7, 7, 28, 28), (7, 7, 56, 56),
                                     (7, 7, 112, 112), (7, 7, 224, 224),
                                     (7, 5, 30, 17)])
def test_resize_matches_jax_image_resize(h, w, H, W):
    """x4, x8, x16, x32 and two ratios that are not integers."""
    x = np.random.default_rng(h * w + H).random((3, h, w), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, H, W),
                                       method="bilinear"))
    got = tgc.resize_bilinear(torch.from_numpy(x), (H, W)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_overlay_heatmap_equals_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    cam = rng.random((24, 20), dtype=np.float32)
    for alpha in (0.4, 0.75):
        np.testing.assert_array_equal(tgc.overlay_heatmap(img, cam, alpha),
                                      jgc.overlay_heatmap(img, cam, alpha))


def test_cam_cli_writes_a_png_of_the_image_size(tmp_path, monkeypatch):
    import cv2
    from medical_image_classification_tpu_torch.cli import cam
    from medical_image_classification_tpu_torch.models import registry
    orig = registry._REGISTRY["medmamba"]
    monkeypatch.setitem(registry._REGISTRY, "medmamba",
                        lambda num_classes, **kw: orig(
                            num_classes, **{**kw, **CFG["medmamba"]}))
    src, out = str(tmp_path / "in.png"), str(tmp_path / "cam.png")
    cv2.imwrite(src, _images(5, n=1, size=40)[0])
    weights = str(tmp_path / "w.pt")
    torch.save(registry.create_model("medmamba", 3).state_dict(), weights)
    heat = cam.main(cam.parse_args(
        ["--image", src, "--num-classes", "3", "--weights", weights,
         "--image-size", "32", "--stages", "layers_1", "--target", "2",
         "--out", out, "--device", "cpu"]))
    assert heat.shape == (32, 32) and 0.0 <= heat.min() <= heat.max() <= 1.0
    written = cv2.imread(out)
    assert written is not None and written.shape == (32, 32, 3)
    assert os.path.getsize(out) > 0


def _stage_calls(monkeypatch, name, size):
    """{kernel: [launches at stage 0, 1, 2, 3]} of the full-width model's
    forward (fp32, batch 2) on meta tensors with the card's gates, each
    kernel's entry point replaced by a stub that records the stage."""
    import medical_image_classification_tpu_torch.models.ss2d_modules as tsm
    import medical_image_classification_tpu_torch.ops.ss2d as tss2d
    stage, calls = [None], {}

    def rec(kernel, out):
        calls.setdefault(kernel, [0] * 4)[stage[0]] += 1
        return out

    def card(gate):
        return lambda *a, **k: gate(*a, **{**k, "card": True})

    monkeypatch.setattr(tss2d, "scan_folded_fwd", lambda u, *a, **k: rec(
        "selective_scan_fwd", torch.empty_like(u)))
    monkeypatch.setattr(tss2d, "ssd_dirs_chunk", card(tssd.ssd_dirs_chunk))
    monkeypatch.setattr(tssd, "ssd_fused_supported",
                        card(tssd.ssd_fused_supported))
    monkeypatch.setattr(tssd, "ydiag_supported", card(tssd.ydiag_supported))
    monkeypatch.setattr(tssd, "ssd_fused_dirs", lambda s, acum, *a, **k: rec(
        "ssd_fused_dirs_fwd", s.new_empty(s.shape[:3] + (acum.shape[2] * 64,
                                                         ))))
    monkeypatch.setattr(tssd, "ssd_fused", lambda *a, **k: rec(
        "ssd_fused_fwd", torch.empty_like(a[6])))
    monkeypatch.setattr(tssd, "ydiag_fused", lambda *a, **k: rec(
        "ssd_ydiag_fwd", torch.empty_like(a[3])))
    monkeypatch.setattr(tsm, "stl_mixer", lambda w, u1, u2, **k: rec(
        "stl_mixer_fwd", w.new_empty(w.shape[0], u1.shape[1], w.shape[2])))
    monkeypatch.setattr(tsm, "stf_zgate", lambda p, lz, U, **k: rec(
        "stf_zgate_fwd", torch.empty_like(p)))
    with torch.device("meta"):
        model = create_model(name, 8).eval()
        for i, layer in enumerate(model.layers):
            layer.register_forward_pre_hook(
                lambda m, a, i=i: stage.__setitem__(0, i))
        with torch.no_grad():
            model(torch.empty(2, size, size, 3))
    return calls


@pytest.mark.parametrize("name", ["medmamba", "medssd", "st_ssd"])
def test_chip_smoke_grad_cam_launches(monkeypatch, name):
    """chip_smoke.py's CAM_PATHS for a Grad-CAM over all four stages: the
    forward kernels of every stage, and the backward kernel of each call in
    the stages after the first (the gradient stops at stage 0's output);
    from the stages of a meta forward at chip_smoke's size."""
    import chip_smoke
    for mod in (tssd, tyd):                    # the card's windows
        monkeypatch.setattr(mod, "_MIN_L", {tssd: 196, tyd: 224}[mod])
    monkeypatch.setattr(tsmp, "_MIN_LP", 512 * 512)
    monkeypatch.setattr(tszp, "_MIN_PP", 512 * 512)
    calls = _stage_calls(monkeypatch, name, chip_smoke.SIZE)
    fwd = {k: sum(v) for k, v in calls.items()}
    bwd = {k.replace("_fwd", "_bwd"): sum(v[1:]) for k, v in calls.items()
           if sum(v[1:])}
    assert (fwd, bwd) == chip_smoke.CAM_PATHS[name]
    assert fwd == chip_smoke._path(name)[0]
