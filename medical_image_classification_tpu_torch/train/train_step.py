"""The train steps.  Port of
``medical_image_classification_tpu/train/train_state.py``:
``cross_entropy_loss`` (``:55-61``), ``make_train_step_fn`` (``:64-96``)
and ``kan_grid_update`` (``:119-133``); and the two-input steps: the cross
classifiers' (cross-entropy, as ``bench.py::bench_cross_cls`` trains them)
and the fusion U-Nets' (``cli/fusion_train.py``'s step: the fused image
clamped to [0, 1], ``fusion_loss``).

The JAX step is a pure function of a ``TrainState``; here the model and the
optimizer carry the parameters, the BatchNorm running stats and the
optimizer state, updated in place, and ``TrainState`` keeps what is left:
the step count and the best validation accuracy.

Under data parallelism (a current mesh whose data axis has dp > 1,
``parallel/mesh.py``) the classifiers' step averages the gradients over
the data axis before the optimizer steps (GSPMD's mean over the global
batch in the JAX step; the seq axis already holds full, identical
gradients and takes no part), its loss and accuracy are the data axis's
means, and ``kan_grid_update`` re-grids on the global batch.  Under
tensor parallelism (tp > 1, the model built with ``model_axis``) the
gradients of the replicated parameters that every model rank computes
inside a layer's region, each rank only its share
(``parallel/sharding.py::redundant_grads``), are first summed over the
model axis; the split leaves' gradients are each rank's own and the rest
are full on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.data.image_folder import (
    normalize_batch,
)
from medical_image_classification_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
)
from medical_image_classification_tpu_torch.parallel.mesh import (
    current_mesh,
    data_axis,
)
from medical_image_classification_tpu_torch.parallel.sharding import (
    redundant_grads,
)
from medical_image_classification_tpu_torch.train.fusion_losses import (
    fusion_loss,
)


@dataclasses.dataclass
class TrainState:
    step: int = 0
    best_acc: float = 0.0


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0):
    """Mean cross-entropy in fp32; with ``label_smoothing`` the one-hot
    target becomes (1 - s) onehot + s / classes."""
    num = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num).to(torch.float32)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(onehot * logp).sum(-1).mean()


def make_train_step(model, optimizer, scheduler=None,
                    label_smoothing: float = 0.0,
                    state: TrainState | None = None) -> Callable:
    """Returns (images_u8 [B, H, W, 3], labels [B]) -> {loss, accuracy}
    (0-d tensors on the batch's device, not synchronised).  One call runs
    the model in train mode (batch statistics, BatchNorm running stats
    updated, DropPath on), back-propagates, steps the optimizer and the
    learning-rate scheduler, and counts the step in ``state``.  Under
    data parallelism the images are this rank's shard of the global
    batch, the gradients are averaged over the data axis and the metrics
    are the global batch's; under tensor parallelism the model is the
    mesh's (``model_axis``), and the redundant gradients are summed over
    the model axis first."""
    mesh = current_mesh()
    redundant = redundant_grads(model.named_parameters(), mesh.tp) \
        if mesh is not None and mesh.tp > 1 else []

    def step_fn(images, labels):
        model.train()
        logits = model(normalize_batch(images))
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        _update(loss, optimizer, scheduler, state, sync=True,
                redundant=redundant)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return _data_mean({"loss": loss.detach(), "accuracy": acc})

    return step_fn


def average_gradients(optimizer, redundant=()) -> None:
    """Average the gradients of ``optimizer``'s parameters over the current
    mesh's data axis (one all-reduce of the flattened gradients); nothing
    without a data axis of more than one rank.  Every rank of the axis
    holds the same model, so the same parameters have gradients on every
    rank.  First, the gradient pieces ``redundant`` lists ((parameter,
    index), ``parallel/sharding.py::redundant_grads``) are summed over the
    model axis, once (one all-reduce)."""
    pieces = [p.grad[i] for p, i in redundant if p.grad is not None]
    if pieces:
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in pieces]),
                           current_mesh().axis("model"))
        for t, piece in zip(pieces, flat.split([t.numel() for t in pieces])):
            t.copy_(piece.view_as(t))
    axis = data_axis()
    if axis is None:
        return
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), axis)
    flat /= axis.size
    for g, piece in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(piece.view_as(g))


def _data_mean(metrics):
    """The metrics' means over the data axis (as they are)."""
    axis = data_axis()
    if axis is None:
        return metrics
    vals = all_reduce_(torch.stack(list(metrics.values())).float(), axis)
    return dict(zip(metrics, (vals / axis.size).unbind(0)))


def _update(loss, optimizer, scheduler, state, sync: bool = False,
            redundant=()):
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if sync:
        average_gradients(optimizer, redundant)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    if state is not None:
        state.step += 1


def make_cross_train_step(model, optimizer, scheduler=None,
                          state: TrainState | None = None) -> Callable:
    """The cross classifiers' step: (xa, xb float [B, H, W, 3], labels [B])
    -> {loss, accuracy}.  The images go to the model as they are (the JAX
    package trains these models on [0, 1] pairs); otherwise as
    ``make_train_step``."""

    def step_fn(xa, xb, labels):
        model.train()
        logits = model(xa, xb)
        loss = cross_entropy_loss(logits, labels)
        _update(loss, optimizer, scheduler, state)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step_fn


def make_fusion_train_step(model, optimizer, scheduler=None,
                           state: TrainState | None = None) -> Callable:
    """The fusion U-Nets' step: (xa, xb float [B, H, W, C] in [0, 1]) ->
    {loss, in, ssim, grad} (0-d tensors, not synchronised): the fused image
    clamped to [0, 1], ``fusion_loss`` against the pair, one optimizer and
    scheduler step, the step counted in ``state``."""

    def step_fn(xa, xb):
        model.train()
        gen = model(xa, xb).clamp(0.0, 1.0)
        total, l_in, l_ssim, l_grad = fusion_loss(xa, xb, gen)
        _update(total, optimizer, scheduler, state)
        return {"loss": total.detach(), "in": l_in.detach(),
                "ssim": l_ssim.detach(), "grad": l_grad.detach()}

    return step_fn


def has_kan_grids(model) -> bool:
    """Whether the model holds KAN grids (the JAX ``kan_state``)."""
    return any(name == "grid" or name.endswith(".grid")
               for name, _ in model.named_buffers())


@torch.no_grad()
def kan_grid_update(model, images):
    """Re-grid the model's KAN head on ``images`` (uint8 [B, H, W, 3]): one
    forward in eval mode (no BatchNorm stat moves) with ``update_grid``,
    which re-fits the ekan and okan heads' grids to the head's inputs and
    their spline weights to keep the function, in place, so an optimizer's
    state stays attached to the parameter.  The other heads and the
    in-block KANs ignore it, as in the JAX package.  The model's mode is
    given back.  Under data parallelism ``images`` is this rank's shard
    of the batch: the shards are gathered over the data axis into the
    global batch (the loader's order, rank r's rows at r::dp), so that
    every rank re-grids on the same batch to the same grids."""
    axis = data_axis()
    if axis is not None:
        shards = all_gather(images, axis)               # [dp, b, H, W, 3]
        images = shards.transpose(0, 1).reshape(
            (-1,) + tuple(images.shape[1:]))
    was_training = model.training
    model.eval()
    try:
        model(normalize_batch(images), update_grid=True)
    finally:
        model.train(was_training)
