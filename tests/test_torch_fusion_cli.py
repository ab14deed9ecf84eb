"""The port's fusion CLIs (``cli/fusion_train.py``, ``cli/fusion_test.py``)
and its copy of the fusion-pair dataset, on a generated folder of four
CT/MRI PNG pairs, on the CPU (asked for explicitly).

``fusion_train.main`` runs 2 steps of vfefm_2b2 at a tiny config
(depths 1-1, dims 8/16, headdim 4, d_state 4, 32x32, batch 2, drop path
off) from weights carried into the JAX package, whose fusion step (the
JAX CLI's: clamp, ``fusion_loss``, Adam 2e-4 on ``fusion_exp``) runs the
same batches from the JAX loader: the per-step losses and their three
parts agree within rtol 1e-2; the saved ``state_dict`` is the trained
model's.  ``fusion_test.main`` writes one PNG a pair from those weights.
``--model fusionmamba`` trains the FusionMamba U-Net on one-channel pairs,
its first loss the JAX step's.  Both CLIs default to the card and raise
without one."""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch

from medical_image_classification_tpu.data import fusion_dataset as jfd
from medical_image_classification_tpu.models.crossmamba import (
    FusionVFEFM as JaxFusionVFEFM,
)
from medical_image_classification_tpu.train.fusion_losses import (
    fusion_loss as jax_fusion_loss,
)
from medical_image_classification_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
    make_schedule as jax_make_schedule,
)
from medical_image_classification_tpu.utils.torch_import import (
    import_vfefm_state_dict,
)
from medical_image_classification_tpu_torch.cli import (
    fusion_test,
    fusion_train,
)
from medical_image_classification_tpu_torch.data import fusion_dataset as tfd
from medical_image_classification_tpu_torch.models import create_fusion_model
from test_torch_crossmamba import perturb_

torch.set_num_threads(2)

TINY = ["--depths", "1,1", "--dims", "8,16", "--headdim", "4",
        "--d-state", "4", "--image-size", "32"]
CFG = dict(depths=(1, 1), dims=(8, 16), depths_decoder=(1, 1),
           dims_decoder=(16, 8), d_state=4, ssd_headdim=4)


def make_pairs(root, n=4, size=40, seed=0):
    """``n`` CT/MRI PNG pairs of seeded noise under ``root``."""
    import cv2
    rng = np.random.RandomState(seed)
    for d in ("CT", "MRI"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            cv2.imwrite(os.path.join(root, d, f"{i}.png"),
                        rng.randint(0, 256, (size, size), np.uint8))


@pytest.fixture(scope="module")
def pairs_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctmri"))
    make_pairs(root)
    return root


def _jax_losses(state_dict, root):
    """The JAX CLI's fusion step, 2 steps from the carried weights on the
    JAX loader's batches: per step (total, in, ssim, grad)."""
    params, stats = import_vfefm_state_dict(
        {k: v.numpy() for k, v in state_dict.items()}, depths=(1, 1),
        depths_decoder=(1, 1), dims=(8, 16), headdim=4)
    model = JaxFusionVFEFM(drop_path_rate=0.0, **CFG)
    loader = jfd.FusionLoader(jfd.scan_fusion_pairs(root), 2, 32, channels=3,
                              seed=0)
    tx = jax_make_optimizer("adam", jax_make_schedule(
        "fusion_exp", 2e-4, loader.steps_per_epoch(), 1, decay=0.75))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, xa, xb):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, xa,
                                   xb, train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(1)})
            parts = jax_fusion_loss(xa, xb, jax.numpy.clip(out, 0.0, 1.0))
            return parts[0], (upd["batch_stats"], parts)

        (_, (stats2, parts)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats2, opt_state, parts

    out = []
    for xa, xb in loader.epoch(0):
        params, stats, opt_state, parts = step(params, stats, opt_state, xa,
                                               xb)
        out.append([float(v) for v in parts])
    return out


def test_fusion_train_matches_the_jax_step_then_test_writes_pngs(
        pairs_root, tmp_path, monkeypatch):
    port = perturb_(create_fusion_model("vfefm_2b2", drop_path_rate=0.0,
                                        **CFG), 11)
    want = _jax_losses(port.state_dict(), pairs_root)
    built = []

    def build_model(args, generator=None):
        assert fusion_train.model_kwargs(args) == dict(
            d_state=4, cat_method="stack", depths=(1, 1),
            depths_decoder=(1, 1), dims=(8, 16), dims_decoder=(16, 8),
            ssd_headdim=4)
        built.append(copy.deepcopy(port))
        return built[-1]

    monkeypatch.setattr(fusion_train, "build_model", build_model)
    save = str(tmp_path / "fusion.pt")
    model, epochs = fusion_train.main(fusion_train.parse_args(
        ["--data-path", pairs_root, "--epochs", "1", "--device", "cpu",
         "--log-every", "1", "--save-path", save] + TINY))
    assert model is built[0] and len(epochs) == 1 and epochs[0]["steps"] == 2
    got = [[epochs[0][k][i] for k in ("loss", "in", "ssim", "grad")]
           for i in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-2)
    saved = torch.load(save, weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in
               model.state_dict().items())

    out_dir = tmp_path / "fused"
    done = fusion_test.main(fusion_test.parse_args(
        ["--data-path", pairs_root, "--weights", save, "--out-dir",
         str(out_dir), "--device", "cpu"] + TINY))
    assert sorted(os.listdir(out_dir)) == [f"{i}_fused.png"
                                           for i in range(4)]
    import cv2
    assert done["seconds"] > 0
    for path in done["paths"]:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert img.shape == (32, 32) and img.dtype == np.uint8


@pytest.mark.parametrize("cli", [fusion_train, fusion_test],
                         ids=["fusion_train", "fusion_test"])
def test_fusion_clis_default_to_the_card_and_raise_without_one(
        monkeypatch, tmp_path, cli):
    """--device cuda by default; without a card main() raises before it
    reads the data: nothing falls back to the CPU."""
    args = cli.parse_args(["--data-path", str(tmp_path / "missing")])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_fusionmamba_is_not_ported_yet(pairs_root, tmp_path, monkeypatch):
    """(Named for the check it replaces: ``--model fusionmamba`` raised
    before FusionMamba was ported.)  ``--model fusionmamba --device cpu``
    trains one epoch on the one-channel pairs at depths 1-1, dims 16/32
    (d_state 16 by default; drop path off): ``--headdim``,
    ``--cat-method`` and ``--single-decoder`` are ignored, as in the JAX
    CLI; the first step's loss and its three parts equal the JAX fusion
    step's loss on the same initial weights (carried by
    ``import_vssm_fusion_state_dict``) and the JAX loader's first batch
    within rtol 1e-2; the saved ``state_dict`` is the trained model's, and
    the JAX importer reads it into the JAX model's parameter tree."""
    from medical_image_classification_tpu.models.fusionmamba import (
        VSSMFusion as JaxVSSMFusion)
    from medical_image_classification_tpu.utils.torch_import import (
        import_vssm_fusion_state_dict)
    from medical_image_classification_tpu_torch.models.fusionmamba import (
        VSSMFusion)
    create = fusion_train.create_fusion_model
    monkeypatch.setattr(fusion_train, "create_fusion_model",
                        lambda name, **kw: create(name, drop_path_rate=0.0,
                                                  **kw))
    save = str(tmp_path / "fusionmamba.pt")
    args = fusion_train.parse_args(
        ["--data-path", pairs_root, "--model", "fusionmamba", "--epochs",
         "1", "--device", "cpu", "--log-every", "1", "--save-path", save,
         "--depths", "1,1", "--dims", "16,32", "--image-size", "32",
         "--headdim", "4", "--cat-method", "add", "--single-decoder"])
    cfg = dict(depths=(1, 1), depths_decoder=(1, 1), dims=(16, 32),
               dims_decoder=(32, 16), d_state=16)
    assert fusion_train.model_kwargs(args) == cfg
    init = fusion_train.build_model(
        args, torch.Generator().manual_seed(args.seed)).state_dict()
    model, epochs = fusion_train.main(args)
    assert isinstance(model, VSSMFusion) and epochs[0]["steps"] == 2
    assert model.patch_embed1.proj.in_channels == 1

    imp = lambda sd: import_vssm_fusion_state_dict(
        {k: v.numpy() for k, v in sd.items()}, depths=(1, 1),
        depths_decoder=(1, 1), dims=(16, 32), d_state=16)
    jmodel = JaxVSSMFusion(drop_path_rate=0.0, **cfg)
    loader = jfd.FusionLoader(jfd.scan_fusion_pairs(pairs_root), 2, 32,
                              channels=1, seed=0)
    xa, xb = next(iter(loader.epoch(0)))
    want = jax.jit(lambda p: jax_fusion_loss(xa, xb, jax.numpy.clip(
        jmodel.apply({"params": p}, xa, xb, train=True), 0.0, 1.0)))(
        imp(init))
    got = [epochs[0][k][0] for k in ("loss", "in", "ssim", "grad")]
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=1e-2)

    saved = torch.load(save, weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in
               model.state_dict().items())
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), xa, xb, train=False))["params"]
    same = jax.tree_util.tree_map(lambda a, s: np.shape(a) == s.shape,
                                  imp(saved), shapes)
    assert all(jax.tree_util.tree_leaves(same))


@pytest.mark.parametrize("channels", [1, 3])
def test_fusion_pairs_and_batches_match_jax(tmp_path, channels):
    """The port's copy of the pair scan, the image load and the loader:
    the same pairs in the same order (``max_pairs`` truncation included)
    and byte-identical batches over two epochs."""
    root = str(tmp_path / "pairs")
    make_pairs(root, n=5, size=37, seed=3)
    os.makedirs(os.path.join(root, "CT", "sub"))
    import cv2
    cv2.imwrite(os.path.join(root, "CT", "sub", "z.png"),
                np.full((20, 30), 9, np.uint8))
    for length in (None, 3):
        jp = jfd.scan_fusion_pairs(root, length=length)
        tp = tfd.scan_fusion_pairs(root, length=length)
        assert (tp.a_paths, tp.b_paths) == (jp.a_paths, jp.b_paths)
    jl = jfd.FusionLoader(jfd.scan_fusion_pairs(root), 2, 24,
                          channels=channels, seed=5)
    tl = tfd.FusionLoader(tfd.scan_fusion_pairs(root), 2, 24,
                          channels=channels, seed=5)
    assert tl.steps_per_epoch() == jl.steps_per_epoch() == 2
    for epoch in (0, 1):
        for (ta, tb), (ja, jb) in zip(tl.epoch(epoch), jl.epoch(epoch)):
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tb, jb)
            assert ta.dtype == np.float32 and ta.shape[-1] == channels
    rgb = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
    for got, want in zip(tfd.rgb_to_ycrcb(rgb), jfd.rgb_to_ycrcb(rgb)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfd.ycrcb_to_rgb(*tfd.rgb_to_ycrcb(rgb)),
                                  jfd.ycrcb_to_rgb(*jfd.rgb_to_ycrcb(rgb)))
    fy = rgb[..., 0][:4, :4]
    np.testing.assert_array_equal(tfd.recombine_fused_y(fy, rgb),
                                  jfd.recombine_fused_y(fy, rgb))
