"""The port's training path on the CPU: BatchNorm's train mode, seeded
DropPath (also under activation checkpointing), the checkpoint round trip,
and the train CLI on a tiny ImageFolder with resume."""

import logging
import os

import numpy as np
import pytest
import torch

import medical_image_classification_tpu_torch.models.registry as registry
from medical_image_classification_tpu_torch.cli.train import main, parse_args
from medical_image_classification_tpu_torch.models import create_model
from medical_image_classification_tpu_torch.models.common import ConvBranch
from medical_image_classification_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from medical_image_classification_tpu_torch.train.optim import (
    make_lr_scheduler,
    make_optimizer,
    make_schedule,
    no_weight_decay_mask,
)
from medical_image_classification_tpu_torch.train.train_step import (
    TrainState,
    make_train_step,
)

torch.set_num_threads(2)
TINY = dict(depths=(1, 1), dims=(16, 32), d_state=4)


def _batch(seed, n=4, size=32, classes=4):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, classes, (n,))))


def test_batch_norm_train_mode_uses_biased_variance():
    """Train mode normalises with the biased batch variance and moves the
    running stats by 0.1 towards the biased batch statistics, as Flax's
    BatchNorm (momentum 0.9) does; n = 2 x 2 x 2 = 8 here, where the
    unbiased variance would be 8/7 of it.  Eval uses the running stats."""
    torch.manual_seed(0)
    branch = ConvBranch(4).train()
    x = 3 * torch.randn(2, 2, 2, 4) + 1
    bn = branch[0]
    branch(x)
    xs = x.reshape(-1, 4).double()
    mean, var = xs.mean(0), xs.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_mean.double(), 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var.double(), 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
    y = branch._batch_norm(bn, x.permute(0, 3, 1, 2), update_stats=False)
    want = (xs - mean) / torch.sqrt(var + bn.eps)
    torch.testing.assert_close(y.permute(0, 2, 3, 1).reshape(-1, 4).double(),
                               want, rtol=1e-5, atol=1e-5)
    before = bn.running_var.clone()
    branch(x, update_stats=False)                  # a recompute: no update
    assert torch.equal(bn.running_var, before)
    y_eval = branch.eval()._batch_norm(bn, x.permute(0, 3, 1, 2), True)
    torch.testing.assert_close(
        y_eval.permute(0, 2, 3, 1).reshape(-1, 4).double(),
        (xs - bn.running_mean.double()) / torch.sqrt(
            bn.running_var.double() + bn.eps), rtol=1e-5, atol=1e-5)


def _one_step(seed, dp_seed, use_checkpoint=False):
    """One Adam step of a tiny model with DropPath at 0.5 on its second
    block: (loss, grads, BatchNorm running stats).  The step must leave
    torch's global RNG alone."""
    model = create_model("medmamba", 4, drop_path_rate=0.5,
                         use_checkpoint=use_checkpoint,
                         generator=torch.Generator().manual_seed(seed),
                         **TINY)
    model.seed_drop_path(dp_seed)
    opt = make_optimizer("adam", model.named_parameters())
    step = make_train_step(model, opt, make_lr_scheduler(
        opt, make_schedule("constant", 1e-3)))
    rng_before = torch.random.get_rng_state()
    m = step(*_batch(0, n=8))
    assert torch.equal(torch.random.get_rng_state(), rng_before)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return float(m["loss"]), grads, stats


def _equal(a, b):
    return a[0] == b[0] and all(
        torch.equal(a[i][k], b[i][k]) for i in (1, 2) for k in a[i])


def test_drop_path_is_seeded_and_repeats_under_checkpointing():
    """DropPath masks come from the model's own generator: the same seed
    gives the same step to the bit, with or without activation
    checkpointing (the recompute reuses the mask and leaves the BatchNorm
    running stats alone), torch's global RNG is not touched, and another
    seed draws other masks."""
    a = _one_step(0, 3)
    assert _equal(a, _one_step(0, 3))
    assert _equal(a, _one_step(0, 3, use_checkpoint=True))
    assert a[0] != _one_step(0, 4)[0]
    # the stream advances: a second draw from one seeded model differs
    model = create_model("medmamba", 4, drop_path_rate=0.5, **TINY).train()
    dp = model.layers[1].blocks[0].drop_path
    x = torch.ones(64, 2, 2, 3)
    assert dp.rate == 0.5 and not torch.equal(dp.mask(x), dp.mask(x))
    model.seed_drop_path(9)
    m1 = dp.mask(x)
    model.seed_drop_path(9)
    assert torch.equal(m1, dp.mask(x))


def _setup(init_seed):
    model = create_model("medmamba", 4, drop_path_rate=0.3,
                         generator=torch.Generator().manual_seed(init_seed),
                         **TINY)
    model.seed_drop_path(1)
    opt = make_optimizer("adamw", model.named_parameters(), weight_decay=0.05,
                         grad_clip=1.0,
                         no_decay_mask=no_weight_decay_mask(model))
    sched = make_lr_scheduler(opt, make_schedule(
        "warmup_cosine", 1e-3, steps_per_epoch=2, epochs=3, warmup_epochs=1))
    state = TrainState()
    return model, opt, sched, state, make_train_step(model, opt, sched,
                                                     state=state)


def test_checkpoint_restore_then_step_is_bit_identical(tmp_path):
    """Save after one step, take a second; a fresh model (other init)
    restored from the save takes the same second step to the bit: weights,
    BatchNorm stats, Adam moments, the schedule's position, the DropPath
    stream and the step count all come back.  Three epochs are kept."""
    ckpt = str(tmp_path / "ckpt")
    assert restore_checkpoint(ckpt, *_setup(0)[:4]) == (-1, 0.0)
    model, opt, sched, state, step = _setup(0)
    step(*_batch(1))
    state.best_acc = 0.25
    save_checkpoint(ckpt, model, opt, sched, state, epoch=0)
    loss_a = float(step(*_batch(2))["loss"])

    model2, opt2, sched2, state2, step2 = _setup(1)
    assert restore_checkpoint(ckpt, model2, opt2, sched2, state2) == (0, 0.25)
    assert state2.step == 1
    loss_b = float(step2(*_batch(2))["loss"])
    assert loss_a == loss_b
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    assert [g["lr"] for g in opt.param_groups] == \
        [g["lr"] for g in opt2.param_groups]

    for epoch in range(1, 5):
        save_checkpoint(ckpt, model, opt, sched, state, epoch=epoch)
    assert sorted(os.listdir(ckpt)) == ["epoch_2.pt", "epoch_3.pt",
                                        "epoch_4.pt"]


def _image_folder(root, n=4, size=32):
    import cv2
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        for cls in ("a", "b"):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                cv2.imwrite(os.path.join(d, f"{i}.png"),
                            rng.randint(0, 256, (size, size, 3), np.uint8))


def test_train_cli_epochs_best_and_resume(tmp_path, monkeypatch, caplog):
    """Two epochs on the CPU write the per-epoch checkpoints, the class
    indices and the best weights; ``--resume`` continues at epoch 2."""
    root = str(tmp_path / "oct")
    _image_folder(root)
    orig = registry._REGISTRY["medmamba"]

    def tiny(num_classes, **kw):
        kw.update(TINY, drop_path_rate=0.1)
        return orig(num_classes, **kw)

    monkeypatch.setitem(registry._REGISTRY, "medmamba", tiny)
    save = str(tmp_path / "runs" / "m.ckpt")
    argv = ["--data-path", os.path.join(root, "train"), "--num-classes", "2",
            "--batch-size", "4", "--image-size", "32", "--save-path", save,
            "--device", "cpu", "--num-workers", "1", "--log-every", "1",
            "--lr", "1e-3"]
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        best = main(parse_args(argv + ["--epochs", "2"]))
    assert sorted(os.listdir(save)) == ["epoch_0.pt", "epoch_1.pt"]
    assert "epoch 1 val top-1" in caplog.text and 0.0 < best <= 1.0
    assert os.path.exists(os.path.join(tmp_path, "runs", "class_indices.json"))
    weights = torch.load(save + ".best", weights_only=True)
    tiny(2).load_state_dict(weights, strict=True)

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mic_torch"):
        main(parse_args(argv + ["--epochs", "3", "--resume", save]))
    assert "resumed from" in caplog.text and "at epoch 1" in caplog.text
    assert "epoch 2 done" in caplog.text and "epoch 0 done" not in caplog.text
    assert sorted(os.listdir(save)) == ["epoch_0.pt", "epoch_1.pt",
                                        "epoch_2.pt"]
    with pytest.raises(NotImplementedError, match="not ported"):
        main(parse_args(argv + ["--tp", "2"]))
