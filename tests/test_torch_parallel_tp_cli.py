"""``cli/ddp_train.py --tp 2`` over 2 gloo ranks on the CPU, and its
checkpoints at any tp.

A tiny medmamba (the registry's, shrunk as ``test_torch_parallel_train.py``
shrinks it) on a generated ImageFolder, SGD with momentum (a parameter-
shaped optimizer state): an epoch at tp 2 against one process's
``cli/train.py`` on the same data (the checkpoint holds the full
``state_dict`` and the full momentum buffers); that checkpoint resumed at
tp 1 for a second epoch, and one process's first epoch resumed at tp 2,
each against the one process's second epoch; the best-model file loaded
strictly into a tp-1 model.  The ranks are spawned CPU processes
(``torch_parallel_workers.py``)."""

import logging
import os
import shutil

import torch

from medical_image_classification_tpu_torch.cli import train as cli_train
from medical_image_classification_tpu_torch.models import registry
from test_torch_parallel_train import TINY, _ckpt, _image_folder, _same_model
from torch_parallel_workers import spawn

torch.set_num_threads(2)


def _same_momentum(got, want, what):
    """Two checkpoints' optimizer states: the same parameters, each
    momentum buffer full-width and within rel-norm 1e-5 of the other's."""
    g, w = got["optimizer"]["state"], want["optimizer"]["state"]
    assert g.keys() == w.keys() and g
    for idx in w:
        a, b = g[idx]["momentum_buffer"], w[idx]["momentum_buffer"]
        assert a.shape == b.shape, (what, idx)
        err = float((a - b).double().norm())
        assert err <= 1e-6 or err <= 1e-5 * float(b.double().norm()), \
            (what, idx, err)


def test_ddp_train_tp_cli_and_its_checkpoints(tmp_path, monkeypatch,
                                              caplog):
    root = str(tmp_path / "oct")
    _image_folder(root)
    argv = ["--data-path", os.path.join(root, "train"), "--num-classes", "2",
            "--batch-size", "4", "--image-size", "32", "--device", "cpu",
            "--num-workers", "1", "--log-every", "1", "--optimizer",
            "momentum", "--lr", "0.05", "--dist-backend", "gloo"]
    save = {s: str(tmp_path / s / "m.ckpt") for s in ("tp", "one", "rev")}
    p = dict(name="medmamba", cfg=TINY,
             argv=argv + ["--save-path", save["tp"], "--epochs", "1",
                          "--tp", "2"])
    spawn("cli", 2, tmp_path, p)
    log = open(os.path.join(tmp_path, "tp", "train.log")).read()
    assert "mesh {'data': 1, 'model': 2, 'seq': 1}" in log
    assert log.count("epoch 0 done") == 1

    monkeypatch.setitem(registry._REGISTRY, "medmamba",
                        lambda num_classes, **kw: registry.medmamba(
                            num_classes, **{**kw, **TINY}))
    cli_train.main(cli_train.parse_args(
        argv + ["--save-path", save["one"], "--epochs", "2"]))
    got, want = _ckpt(save["tp"], 0), _ckpt(save["one"], 0)
    assert got["step"] == want["step"] == 2
    assert {k: v.shape for k, v in got["model"].items()} == \
        {k: v.shape for k, v in want["model"].items()}
    _same_model(got, want, "tp epoch 0")
    _same_momentum(got, want, "tp epoch 0")
    # the best-model file is the full state_dict
    tiny = registry._REGISTRY["medmamba"]
    tiny(2).load_state_dict(torch.load(save["tp"] + ".best",
                                       weights_only=True), strict=True)

    # tp 2 -> tp 1: the second epoch in one process
    resumed = str(tmp_path / "tp1" / "m.ckpt")
    shutil.copytree(save["tp"], resumed)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        cli_train.main(cli_train.parse_args(
            argv + ["--save-path", resumed, "--epochs", "2", "--resume",
                    resumed]))
    logs = {resumed: caplog.text}
    # tp 1 -> tp 2: one process's first epoch, the second at tp 2
    os.makedirs(save["rev"])
    shutil.copy(os.path.join(save["one"], "epoch_0.pt"), save["rev"])
    p["argv"] = argv + ["--save-path", save["rev"], "--epochs", "2",
                        "--tp", "2", "--resume", save["rev"]]
    spawn("cli", 2, tmp_path, p)
    logs[save["rev"]] = open(os.path.join(tmp_path, "rev",
                                          "train.log")).read()
    want = _ckpt(save["one"], 1)
    for what, path in (("tp 2 -> 1", resumed), ("tp 1 -> 2", save["rev"])):
        assert "resumed from" in logs[path], what
        assert "epoch 0 done" not in logs[path], what
        got = _ckpt(path, 1)
        assert got["step"] == want["step"] == 4, what
        _same_model(got, want, what)
        _same_momentum(got, want, what)
