"""Optimizer and learning-rate schedule factory.

Port of ``medical_image_classification_tpu/train/optim.py``: 9 optimizers
and 8 schedules by name, each matching its optax counterpart step for step.

- A schedule is a function step -> lr, counting from the first update, as
  optax's are.  ``make_lr_scheduler`` drives it through ``LambdaLR`` over an
  optimizer built with lr 1.0, so each group's lr is the schedule's value.
- ``no_weight_decay_mask`` and the decay of adamw, lamb and lion become
  param groups (decayed, not decayed).
- ``grad_clip`` is optax's ``clip_by_global_norm``, run as a step pre-hook:
  gradients are scaled by max_norm / norm when the global norm reaches
  max_norm, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
- Under tensor parallelism (an optimizer made under a current mesh with
  tp > 1, over the parameters of a model built with ``model_axis``) the
  norms that span a tensor, the clip's global norm and lamb's per-tensor
  norms, are those of the full tensors, as GSPMD computes them: the
  squares of a split leaf's split blocks are summed over the model axis,
  replicated blocks and leaves count once (``parallel/sharding.py``).

Where torch's class computes something else, the optimizer is written here
from optax's formulas: rmsprop (optax: decay 0.9, eps inside the square
root, the lr applied before the momentum trace; torch: alpha 0.99, eps
outside, lr after), adagrad (optax: accumulator from 0.1, eps 1e-7 inside
the root; torch: from 0, eps 1e-10 outside), and lamb and lion (no torch
class).  adam, adamw, sgd, momentum and nesterov are torch's classes, whose
updates equal optax's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from medical_image_classification_tpu_torch.parallel.collectives import (
    all_reduce_,
)
from medical_image_classification_tpu_torch.parallel.mesh import current_mesh
from medical_image_classification_tpu_torch.parallel.sharding import (
    split_rules,
    split_sq_sums,
)

# parameters never decayed: the JAX mask's leaf names (a norm layer's
# weight is Flax's "scale")
_NO_DECAY = ("A_logs", "Ds", "dt_projs_bias", "dt_bias", "bias", "scale",
             "norm_weight", "k_weights")
_NORMS = (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def _constant(value):
    return lambda step: value


def _exponential_decay(init, transition_steps, rate):
    """optax.exponential_decay(..., staircase=True)."""
    if transition_steps <= 0 or rate == 0:
        return _constant(init)
    return lambda step: (init if step <= 0 else
                         init * rate ** math.floor(step / transition_steps))


def _linear(init, end, steps):
    """optax.linear_schedule."""
    if steps <= 0:
        return _constant(init)
    return lambda step: (init - end) * (
        1 - min(max(step, 0), steps) / steps) + end


def _cosine(init, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def sched(step):
        c = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps)
                                / decay_steps))
        return init * ((1 - alpha) * c + alpha)
    return sched


def _join(schedules, boundaries):
    """optax.join_schedules: the k-th schedule from boundary k-1 on,
    counting from that boundary."""
    def sched(step):
        out = schedules[0](step)
        for b, s in zip(boundaries, schedules[1:]):
            if step >= b:
                out = s(step - b)
        return out
    return sched


def make_schedule(name: str = "constant", base_lr: float = 1e-4,
                  steps_per_epoch: int = 1, epochs: int = 100,
                  warmup_epochs: int = 0, step_size: int = 30,
                  gamma: float = 0.1, milestones=(30, 60, 90),
                  min_lr: float = 0.0, decay: float = 0.75):
    """name: constant | step | multistep | exponential | cosine |
    warmup_cosine | warmup_constant | fusion_exp (lr * decay^epoch)."""
    spe = max(1, steps_per_epoch)
    warm = warmup_epochs * spe
    if name == "constant":
        return _constant(base_lr)
    if name == "step":
        return _exponential_decay(base_lr, step_size * spe, gamma)
    if name == "multistep":
        bounds = sorted({int(m * spe) for m in milestones})
        return lambda step: base_lr * gamma ** sum(step >= b for b in bounds)
    if name == "exponential":
        return _exponential_decay(base_lr, spe, gamma)
    if name == "cosine":
        return _cosine(base_lr, epochs * spe, min_lr / max(base_lr, 1e-12))
    if name == "warmup_cosine":
        alpha = 0.0 if base_lr == 0 else min_lr / base_lr
        return _join([_linear(0.0, base_lr, warm),
                      _cosine(base_lr, epochs * spe - warm, alpha)], [warm])
    if name == "warmup_constant":
        return _join([_linear(0.0, base_lr, warm), _constant(base_lr)],
                     [warm])
    if name == "fusion_exp":
        return _exponential_decay(base_lr, spe, decay)
    raise ValueError(f"unknown schedule: {name}")


def make_lr_scheduler(optimizer, schedule):
    """Drive ``schedule`` (step -> lr) through the optimizer's groups, which
    ``make_optimizer`` builds with lr 1.0.  Step it once per update."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def no_weight_decay_mask(model: nn.Module):
    """{parameter name: True if decayed}.  Excludes A_logs, Ds, the Δ bias,
    every bias, and norm weights and anything under a module named *norm*,
    as the JAX mask does (the reference's ``_no_weight_decay`` tags)."""
    mask = {}
    for mod_name, mod in model.named_modules():
        path = mod_name.split(".") if mod_name else []
        for p_name, _ in mod.named_parameters(recurse=False):
            leaf = ("scale" if isinstance(mod, _NORMS) and p_name == "weight"
                    else p_name)
            mask[".".join(path + [p_name])] = not (
                leaf in _NO_DECAY or any("norm" in c.lower() for c in path))
    return mask


class _Optax(torch.optim.Optimizer):
    """An elementwise optax chain as a torch optimizer: ``_update`` returns
    the update (before the learning rate) for one parameter."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._apply(p, p.grad, self.state[p], group)
        return loss


class RMSprop(_Optax):
    """optax.rmsprop(lr, decay, eps, momentum): nu = decay nu + (1 - decay)
    g^2; t = lr g / sqrt(nu + eps) + momentum t; p -= t."""

    def __init__(self, params, lr=1.0, decay=0.9, eps=1e-8, momentum=0.9):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    def _apply(self, p, g, st, group):
        if not st:
            st["nu"] = torch.zeros_like(p)
            st["trace"] = torch.zeros_like(p)
        d = group["decay"]
        st["nu"].mul_(d).add_((1 - d) * g * g)
        u = group["lr"] * g * torch.rsqrt(st["nu"] + group["eps"])
        st["trace"].mul_(group["momentum"]).add_(u)
        p.sub_(st["trace"])


class Adagrad(_Optax):
    """optax.adagrad(lr, initial_accumulator_value=0.1, eps=1e-7):
    s += g^2; p -= lr g / sqrt(s + eps) (0 where s is 0)."""

    def __init__(self, params, lr=1.0, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, dict(lr=lr, init=initial_accumulator_value,
                                      eps=eps))

    def _apply(self, p, g, st, group):
        if not st:
            st["sum_sq"] = torch.full_like(p, group["init"])
        s = st["sum_sq"].add_(g * g)
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
        p.sub_(group["lr"] * inv * g)


class Lamb(_Optax):
    """optax.lamb(lr, b1, b2, eps, weight_decay): the Adam direction plus
    decay, scaled per tensor by |p| / |update| (1 where either is 0)."""

    def __init__(self, params, lr=1.0, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.0, tp_rules=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.tp_rules = tp_rules

    def _apply(self, p, g, st, group):
        if not st:
            st["count"] = 0
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
        b1, b2 = group["b1"], group["b2"]
        st["count"] += 1
        st["mu"].mul_(b1).add_((1 - b1) * g)
        st["nu"].mul_(b2).add_((1 - b2) * g * g)
        mu_hat = st["mu"] / (1 - b1 ** st["count"])
        nu_hat = st["nu"] / (1 - b2 ** st["count"])
        u = mu_hat / (nu_hat.sqrt() + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        if self.tp_rules is None:
            pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        else:
            pn, un = (_tp_norm(t, self.tp_rules.get(p)) for t in (p, u))
        ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
        p.sub_(group["lr"] * u * ratio)


class Lion(_Optax):
    """optax.lion(lr, b1, b2, weight_decay): update sign((1 - b1) g + b1 mu)
    plus decay; then mu = (1 - b2) g + b2 mu."""

    def __init__(self, params, lr=1.0, b1=0.9, b2=0.99, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    def _apply(self, p, g, st, group):
        if not st:
            st["mu"] = torch.zeros_like(p)
        b1, b2 = group["b1"], group["b2"]
        u = torch.sign((1 - b1) * g + b1 * st["mu"])
        st["mu"].mul_(b2).add_((1 - b2) * g)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.sub_(group["lr"] * u)


def _tp_norm(t, rule):
    """The norm of the full tensor of which ``t`` is this model rank's
    (``rule`` its Split, None: replicated)."""
    axis = current_mesh().axis("model")
    split, rep = split_sq_sums(t, rule, axis.size)
    return torch.sqrt(all_reduce_(split, axis) + rep)


def _tp_rules(named):
    """{parameter: Split} of the split parameters among ``named`` under the
    current mesh's tensor parallelism, or None without it."""
    mesh = current_mesh()
    if mesh is None or mesh.tp == 1:
        return None
    rules = split_rules({n: tuple(p.shape) for n, p in named}, mesh.tp,
                        local=True)
    return {p: rules[n] for n, p in named if n in rules}


def _clip_hook(max_norm, tp_rules=None):
    """optax.clip_by_global_norm before the step; with ``tp_rules`` the
    norm of the full tree over the model axis (one all-reduce)."""
    def hook(optimizer, args, kwargs):
        params = [p for group in optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        if not grads:
            return
        if tp_rules is None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        else:
            axis = current_mesh().axis("model")
            sums = [split_sq_sums(p.grad, tp_rules.get(p), axis.size)
                    for p in params]
            norm = torch.sqrt(all_reduce_(sum(s for s, _ in sums), axis)
                              + sum(r for _, r in sums))
        if not bool(norm < max_norm):
            for g in grads:
                g.div_(norm).mul_(max_norm)
    return hook


def make_optimizer(name: str, named_params, weight_decay: float = 0.0,
                   momentum: float = 0.9, grad_clip: float | None = None,
                   no_decay_mask=None):
    """name: adam | adamw | sgd | momentum | nesterov | rmsprop | adagrad |
    lamb | lion, over ``named_params`` ((name, parameter) pairs).  adamw,
    lamb and lion decay by ``weight_decay`` the parameters that
    ``no_decay_mask`` marks True (all of them without a mask).  Every group
    has lr 1.0: pair the optimizer with ``make_lr_scheduler``."""
    named = list(named_params)
    tp_rules = _tp_rules(named)
    decays = name in ("adamw", "lamb", "lion")
    if decays and no_decay_mask is not None:
        groups = [dict(params=[p for n, p in named if no_decay_mask[n]],
                       weight_decay=weight_decay),
                  dict(params=[p for n, p in named if not no_decay_mask[n]],
                       weight_decay=0.0)]
        groups = [gr for gr in groups if gr["params"]]
    else:
        groups = [dict(params=[p for _, p in named],
                       weight_decay=weight_decay if decays else 0.0)]
    if name == "adam":
        opt = torch.optim.Adam(groups, lr=1.0)
    elif name == "adamw":
        opt = torch.optim.AdamW(groups, lr=1.0)
    elif name == "sgd":
        opt = torch.optim.SGD(groups, lr=1.0)
    elif name == "momentum":
        opt = torch.optim.SGD(groups, lr=1.0, momentum=momentum)
    elif name == "nesterov":
        opt = torch.optim.SGD(groups, lr=1.0, momentum=momentum,
                              nesterov=True)
    elif name == "rmsprop":
        opt = RMSprop(groups, momentum=momentum)
    elif name == "adagrad":
        opt = Adagrad(groups)
    elif name == "lamb":
        opt = Lamb(groups, tp_rules=tp_rules)
    elif name == "lion":
        opt = Lion(groups)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    if grad_clip:
        opt.register_step_pre_hook(_clip_hook(grad_clip, tp_rules))
    return opt
