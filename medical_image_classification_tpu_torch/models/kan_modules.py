"""KAN layers and the classifier heads.

Port of ``medical_image_classification_tpu/models/kan_modules.py``:
``KANLinear`` (efficient-KAN), ``OKANLayer`` (original pykan),
``KansModule``, ``ThreeKansModule``, and ``ClassifierHead``'s six kinds
(``head_modules``, ``classify``).  A layer's B-spline ``grid`` (and an o-KAN layer's ``mask``) is a
buffer, the JAX package's ``kan_state`` collection: saved with the model,
never trained.  ``update_grid=True`` re-fits the grid to the batch and the
spline weights to keep the function, writing both in place under
``no_grad`` (the parameter stays the same object, so an optimizer's state
stays attached to it).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from medical_image_classification_tpu_torch.models.common import batch_norm
from medical_image_classification_tpu_torch.ops import kan as kan_ops


def _kaiming_uniform_a_(w, a: float, generator=None):
    """torch's kaiming_uniform_ with negative slope ``a`` and fan_in the
    last axis: U(-b, b), b = sqrt(6 / ((1 + a^2) fan_in))."""
    bound = math.sqrt(6.0 / ((1.0 + a * a) * w.shape[-1]))
    return nn.init.uniform_(w, -bound, bound, generator=generator)


class KANLinear(nn.Module):
    """Efficient-KAN layer: silu(x) W_baseᵀ + B-splines(x) ·
    (W_spline · scaler), in fp32, returned in x's dtype.  The JAX module's
    other fields keep their defaults in every model (grid size 5, noise
    0.1, base and spline scales 1, a standalone scaler, grid range
    [-1, 1]), so they are constants here."""

    grid_size = 5

    def __init__(self, in_features: int, features: int,
                 spline_order: int = 1):
        super().__init__()
        self.spline_order = spline_order
        grid_size = self.grid_size
        self.register_buffer("grid", kan_ops.make_grid(
            in_features, grid_size, spline_order))
        self.base_weight = nn.Parameter(torch.empty(features, in_features))
        self.spline_weight = nn.Parameter(
            torch.empty(features, in_features, grid_size + spline_order))
        self.spline_scaler = nn.Parameter(torch.empty(features, in_features))

    def reset_parameters(self, generator=None):
        """The JAX init: kaiming-uniform (a = sqrt 5) base weight and
        scaler, spline weights fit to U(-0.05, 0.05) / grid_size noise on
        the initial grid."""
        gs, k = self.grid_size, self.spline_order
        out_f, in_f = self.base_weight.shape
        grid0 = kan_ops.make_grid(in_f, gs, k)
        with torch.no_grad():
            self.grid.copy_(grid0)
            _kaiming_uniform_a_(self.base_weight, math.sqrt(5), generator)
            if self.base_weight.is_meta:
                return
            noise = ((torch.rand(gs + 1, in_f, out_f, generator=generator)
                      - 0.5) * 0.1 / gs)
            pts = grid0[:, k:-k].t() if k > 0 else grid0.t()
            self.spline_weight.copy_(kan_ops.curve2coeff(pts, noise, grid0,
                                                         k))
            _kaiming_uniform_a_(self.spline_scaler, math.sqrt(5), generator)

    def forward(self, x, update_grid: bool = False):
        if update_grid:
            x2 = x.reshape(-1, x.shape[-1]).float()
            with torch.no_grad():
                grid, w = kan_ops.kan_update_grid(
                    x2, self.grid, self.spline_weight, self.spline_scaler,
                    grid_size=self.grid_size, spline_order=self.spline_order)
                self.grid.copy_(grid)
                self.spline_weight.copy_(w)
        return kan_ops.kan_linear(x, self.grid, self.base_weight,
                                  self.spline_weight, self.spline_scaler,
                                  self.spline_order)


class OKANLayer(nn.Module):
    """Original pykan layer: per-edge spline activations plus a silu base,
    weighted by ``scale_base`` / ``scale_sp`` and masked.  The JAX
    module's other fields keep their defaults in every model (noise 0.5,
    scale_base around 0 with spread 1, scale_sp 1, grid range [-1, 1],
    dense connectivity), so they are constants here."""

    def __init__(self, in_dim: int, out_dim: int, num: int = 5, k: int = 3):
        super().__init__()
        self.num, self.k = num, k
        self.register_buffer("grid", self._grid0(in_dim))
        self.register_buffer("mask", torch.ones(in_dim, out_dim))
        self.coef = nn.Parameter(torch.empty(in_dim, out_dim, num + k))
        self.scale_base = nn.Parameter(torch.empty(in_dim, out_dim))
        self.scale_sp = nn.Parameter(torch.empty(in_dim, out_dim))

    def _grid0(self, in_dim):
        g = kan_ops._linspace_f32(-1.0, 1.0, self.num + 1)
        return kan_ops.extend_grid(g.expand(in_dim, -1), self.k)

    def reset_parameters(self, generator=None):
        """The JAX init: coefficients fit to U(-0.25, 0.25) / num noise,
        scale_base U(-1, 1) / sqrt(in), scale_sp the mask."""
        in_dim, out_dim = self.scale_base.shape
        grid0 = self._grid0(in_dim)
        with torch.no_grad():
            self.grid.copy_(grid0)
            self.mask.fill_(1.0)
            if self.coef.is_meta:
                return
            noise = ((torch.rand(self.num + 1, in_dim, out_dim,
                                 generator=generator) - 0.5)
                     * 0.5 / self.num)
            pts = grid0[:, self.k:-self.k].t()
            self.coef.copy_(kan_ops.okan_curve2coef(pts, noise, grid0,
                                                    self.k))
            r = torch.rand(in_dim, out_dim, generator=generator) * 2.0 - 1.0
            self.scale_base.copy_(r / math.sqrt(in_dim))
            self.scale_sp.copy_(self.mask)

    def forward(self, x, update_grid: bool = False,
                return_acts: bool = False):
        """y [..., out] in x's dtype; with ``return_acts`` (y, preacts,
        postacts, postspline) as ``kan_ops.okan_forward`` gives them, y
        in fp32 (the JAX layer's)."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if update_grid:
            with torch.no_grad():
                grid, coef = kan_ops.okan_update_grid(
                    x2.float(), self.grid, self.coef, self.k, self.num)
                self.grid.copy_(grid)
                self.coef.copy_(coef)
        out = kan_ops.okan_forward(x2, self.grid, self.coef, self.scale_base,
                                   self.scale_sp, self.mask, self.k,
                                   return_acts=return_acts)
        if return_acts:
            y, pre, post, postsp = out
            return (y.reshape(lead + (y.shape[-1],)), pre, post, postsp)
        return out.reshape(lead + (out.shape[-1],)).to(x.dtype)


def _bn1d(features: int) -> nn.BatchNorm1d:
    """Flax BatchNorm(momentum 0.9, eps 1e-5) over [B, C]."""
    return nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)


class KansModule(nn.Module):
    """kan1 -> BN -> + residual -> kan2."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kan1 = OKANLayer(in_dim, in_dim)
        self.bn = _bn1d(in_dim)
        self.kan2 = OKANLayer(in_dim, features)

    def forward(self, x):
        h = batch_norm(self.bn, self.kan1(x), self.training)
        return self.kan2(h + x)


class ThreeKansModule(nn.Module):
    """kan1 -> BN -> kan2 -> BN -> + residual -> kan3, ONE BatchNorm at
    both hops (in train mode its running stats move twice a forward)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.kan1 = OKANLayer(in_dim, in_dim)
        self.bn = _bn1d(in_dim)
        self.kan2 = OKANLayer(in_dim, in_dim)
        self.kan3 = OKANLayer(in_dim, features)

    def forward(self, x):
        h = batch_norm(self.bn, self.kan1(x), self.training)
        h = batch_norm(self.bn, self.kan2(h), self.training)
        return self.kan3(h + x)


HEAD_KINDS = ("linear", "ekan", "okan", "kan_stack", "kan_module", "3kan")


def head_modules(in_features: int, num_classes: int, kind: str = "linear",
                 ekan_spline_order: int = 1) -> dict:
    """The modules of the JAX ``ClassifierHead`` of ``kind``, under the
    reference's names, which are top-level keys of the model's
    ``state_dict``: ``head`` for linear, ``kan`` for ekan and okan,
    ``kan1``-``kan3`` for kan_stack, ``kans`` for kan_module and 3kan.
    The model registers them as its own children."""
    if kind == "linear":
        return {"head": nn.Linear(in_features, num_classes)}
    if kind == "ekan":
        return {"kan": KANLinear(in_features, num_classes,
                                 spline_order=ekan_spline_order)}
    if kind == "okan":
        return {"kan": OKANLayer(in_features, num_classes)}
    if kind == "kan_stack":
        # (num 5, k 3) -> (num 7, k 5) -> (num 5, k 3)
        return {"kan1": OKANLayer(in_features, in_features, num=5, k=3),
                "kan2": OKANLayer(in_features, in_features, num=7, k=5),
                "kan3": OKANLayer(in_features, num_classes, num=5, k=3)}
    if kind == "kan_module":
        return {"kans": KansModule(in_features, num_classes)}
    if kind == "3kan":
        return {"kans": ThreeKansModule(in_features, num_classes)}
    raise ValueError(f"unknown head kind: {kind!r}")


def classify(owner: nn.Module, kind: str, x, update_grid: bool = False):
    """The head's forward over the modules ``head_modules`` put on
    ``owner``.  ``update_grid`` re-grids the ekan and okan heads only, as
    the JAX module passes it to those alone."""
    if kind == "linear":
        return owner.head(x)
    if kind in ("ekan", "okan"):
        return owner.kan(x, update_grid=update_grid)
    if kind == "kan_stack":
        return owner.kan3(owner.kan2(owner.kan1(x)))
    return owner.kans(x)
