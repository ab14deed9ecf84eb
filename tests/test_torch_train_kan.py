"""The train CLI's KAN re-grid on the CPU: ``--model medssd_ekan
--kan-update-grid-every 1`` (shrunk through the registry) for two epochs
on a generated ImageFolder re-grids once an epoch, on the epoch's first
batch; the grids go into the checkpoint and ``--resume`` restores them;
Adam's state stays with the re-fit parameter."""

import logging
import os

import numpy as np
import torch

import medical_image_classification_tpu_torch.models.registry as registry
from medical_image_classification_tpu_torch.cli import train as train_cli
from medical_image_classification_tpu_torch.cli.train import main, parse_args
from medical_image_classification_tpu_torch.train import train_step

torch.set_num_threads(2)
TINY = dict(depths=(1, 1), dims=(16, 32), ssd_headdim=8)


def _image_folder(root, n=4, size=32, seed=0):
    import cv2
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        for cls in ("a", "b"):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                cv2.imwrite(os.path.join(d, f"{i}.png"),
                            rng.randint(0, 256, (size, size, 3), np.uint8))


def test_train_cli_regrids_every_epoch_and_resumes(tmp_path, monkeypatch,
                                                    caplog):
    root = str(tmp_path / "oct")
    _image_folder(root)
    orig = registry._REGISTRY["medssd_ekan"]
    monkeypatch.setitem(registry._REGISTRY, "medssd_ekan",
                        lambda num_classes, **kw: orig(num_classes,
                                                       **{**kw, **TINY}))
    # record each re-grid: the head's grid and spline weight before and
    # after, Adam's state of the spline weight
    seen = []
    regrid = train_step.kan_grid_update

    def spy(model, images):
        head = model.kan
        opt_state = spy.optimizer.state.get(head.spline_weight)
        before = (head.grid.clone(), head.spline_weight.detach().clone(),
                  head.spline_weight)
        regrid(model, images)
        seen.append(dict(
            grid_moved=not torch.equal(head.grid, before[0]),
            w_moved=not torch.equal(head.spline_weight, before[1]),
            same_param=head.spline_weight is before[2],
            adam_kept=opt_state is not None and spy.optimizer.state.get(
                head.spline_weight) is opt_state,
            images=images.shape[0], grid_before=before[0],
            grid=head.grid.clone()))

    make_opt = train_cli.make_optimizer

    def opt_spy(*a, **k):
        spy.optimizer = make_opt(*a, **k)
        return spy.optimizer

    monkeypatch.setattr(train_cli, "kan_grid_update", spy)
    monkeypatch.setattr(train_cli, "make_optimizer", opt_spy)
    save = str(tmp_path / "runs" / "k.ckpt")
    argv = ["--data-path", os.path.join(root, "train"), "--model",
            "medssd_ekan", "--num-classes", "2", "--batch-size", "4",
            "--image-size", "32", "--save-path", save, "--device", "cpu",
            "--num-workers", "1", "--lr", "1e-3",
            "--kan-update-grid-every", "1"]
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        main(parse_args(argv + ["--epochs", "2"]))
    assert caplog.text.count("KAN grids updated at epoch") == 2
    assert len(seen) == 2
    for s in seen:
        assert s["grid_moved"] and s["w_moved"] and s["same_param"], s
        assert s["adam_kept"] and s["images"] == 4, s
    ckpt = torch.load(os.path.join(save, "epoch_1.pt"), weights_only=True)
    assert torch.equal(ckpt["model"]["kan.grid"], seen[-1]["grid"])
    assert any(v.dim() == 3 and v.shape[-1] == 8
               for v in (st.get("exp_avg") for st in
                         ckpt["optimizer"]["state"].values()) if v is not None)

    # resume: the run goes on at epoch 2 from the grid saved at epoch 1
    # (a buffer: training leaves it alone until the next re-grid)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        main(parse_args(argv + ["--epochs", "3", "--resume", save]))
    assert "at epoch 1" in caplog.text and "epoch 2 done" in caplog.text
    assert len(seen) == 3 and seen[2]["adam_kept"]
    assert torch.equal(seen[2]["grid_before"], seen[1]["grid"])
    ckpt = torch.load(os.path.join(save, "epoch_2.pt"), weights_only=True)
    assert torch.equal(ckpt["model"]["kan.grid"], seen[2]["grid"])


def test_kan_grid_update_leaves_batch_stats_and_mode(monkeypatch):
    """The re-grid runs in eval mode (no BatchNorm stat moves), hands the
    mode back, and re-grids only the ekan / okan head: a kanin model's
    in-block grids stay as they were."""
    from medical_image_classification_tpu_torch.models import create_model
    images = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    for name, moved in (("medssd_okan", {"kan.grid", "kan.coef"}),
                        ("kanin_ssd", set()), ("medssd_3kan", set())):
        model = create_model(name, 3, **TINY).train()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert train_step.has_kan_grids(model)
        train_step.kan_grid_update(model, images)
        assert model.training
        got = {k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
        assert got == moved, (name, got)
    assert not train_step.has_kan_grids(create_model("cnn_mamba", 3, **TINY))
