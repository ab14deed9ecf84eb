"""Shared building blocks of the VSSM family (PyTorch, NHWC activations).

Port of ``medical_image_classification_tpu/models/common.py``.  Activations
stay channel-last as in the JAX package; a convolution sees its input as an
NCHW tensor in channels-last memory (a permuted view, no copy).

Compute dtype: parameters are fp32.  A module given ``dtype`` (bf16, say)
runs its matmuls and convolutions in that dtype, as a Flax module with
``dtype`` set does; with ``dtype=None`` they run in fp32.  LayerNorm keeps
fp32 statistics and returns fp32, as Flax's LayerNorm with fp32 parameters
does, and the caller casts where the JAX module casts.

Parameter names follow the reference PyTorch ``state_dict`` so that
``medical_image_classification_tpu.utils.torch_import`` reads a port
``state_dict()`` as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def trunc_normal_02_(w, generator=None):
    """Flax ``truncated_normal(stddev=0.02)``, the Dense kernel init: N(0, 1)
    cut at +-2, times 0.02, with no correction for the cut (so the std is
    0.02 x 0.88, unlike variance_scaling's truncated normal)."""
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(0.02)


def kaiming_conv_(w, generator=None):
    """Flax ``variance_scaling(2.0, "fan_out", "normal")``: the conv init."""
    return nn.init.kaiming_normal_(w, mode="fan_out", nonlinearity="relu",
                                   generator=generator)


def _compute_dtype(dtype, x):
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               torch.float32)


def linear(mod: nn.Linear, x, dtype=None):
    """``mod`` applied in the compute dtype (a Flax Dense with ``dtype``)."""
    cd = _compute_dtype(dtype, x)
    bias = None if mod.bias is None else mod.bias.to(cd)
    return F.linear(x.to(cd), mod.weight.to(cd), bias)


def conv_nhwc(mod: nn.Conv2d, x, dtype=None):
    """``mod`` on an NHWC tensor, in the compute dtype; returns NHWC."""
    cd = _compute_dtype(dtype, x)
    bias = None if mod.bias is None else mod.bias.to(cd)
    y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), mod.weight.to(cd), bias,
                 mod.stride, mod.padding, mod.dilation, mod.groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(mod: nn.LayerNorm, x):
    """fp32 statistics and fp32 output (Flax LayerNorm, fp32 params)."""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight,
                        mod.bias, mod.eps)


def channel_shuffle(x, groups: int):
    """ShuffleNet channel interleave in NHWC: group slices stacked on a new
    trailing axis, then flattened."""
    b, h, w, c = x.shape
    step = c // groups
    parts = [x[..., i * step:(i + 1) * step] for i in range(groups)]
    return torch.stack(parts, dim=-1).reshape(b, h, w, c)


class SeededGenerators:
    """One ``torch.Generator`` per device, each seeded with ``seed`` when
    first asked for: a model's own source of random masks, so that a run is
    repeatable from its seed whatever else draws from torch's global RNG."""

    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self.seed = seed
        self._gens = {}

    def get(self, device) -> torch.Generator:
        key = str(torch.device(device))
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key).manual_seed(self.seed)
            self._gens[key] = gen
        return gen

    def get_state(self):
        return {key: gen.get_state() for key, gen in self._gens.items()}

    def set_state(self, states):
        for key, state in states.items():
            # a generator's state is a CPU byte tensor, whatever its device
            self.get(key).set_state(state.cpu())


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode.

    Masks come from ``rng`` (a ``SeededGenerators`` the model owns and
    shares among its blocks; a private one seeded 0 if none is given)."""

    def __init__(self, rate: float = 0.0, rng: SeededGenerators | None = None):
        super().__init__()
        self.rate = rate
        self.rng = rng if rng is not None else SeededGenerators(0)

    def mask(self, x):
        """A keep mask [B, 1, ...] drawn for ``x``, or None when the path is
        the identity (eval, or rate 0)."""
        if not self.training or self.rate == 0.0:
            return None
        return torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                           device=x.device).bernoulli_(
            1.0 - self.rate, generator=self.rng.get(x.device))

    def drop(self, x, mask):
        """Zero the samples ``mask`` drops and scale the kept ones by
        1 / keep; None is the identity."""
        if mask is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(mask.bool(), x / keep, 0.0).to(x.dtype)

    def forward(self, x):
        return self.drop(x, self.mask(x))


class PatchEmbed(nn.Module):
    """4x4 conv patchify of RGB + LayerNorm.  NHWC in/out."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        # parity: Flax's LayerNorm eps is 1e-6, torch's default 1e-5
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        x = conv_nhwc(self.proj, x, self.dtype)
        # fp32 statistics, output back in the compute dtype
        x = layer_norm(self.norm, x)
        return x if self.dtype is None else x.to(self.dtype)


class PatchMerging(nn.Module):
    """2x2 space-to-depth -> LN -> Linear 4C -> 2C.  Odd sizes are cropped."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)     # parity: Flax eps
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x[:, :(h // 2) * 2, :(w // 2) * 2, :]
        # the order of the four NHWC sub-grids fixes the weight layout
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = layer_norm(self.norm, torch.cat([x0, x1, x2, x3], dim=-1))
        return linear(self.reduction, x, self.dtype)


class ConvBranch(nn.Sequential):
    """The SS-Conv block's conv half: BN-3x3-BN-ReLU-3x3-BN-ReLU-1x1-ReLU.

    A Sequential so that its children carry the reference's indices
    (0, 2, 5 BatchNorm; 1, 4, 7 Conv).  NHWC in/out.  BatchNorm eps is 1e-5
    (as in the JAX module); in eval it normalises with the running stats.
    Flax's momentum 0.9 is torch's 0.1."""

    def __init__(self, dim: int, dtype=None):
        bn = lambda: nn.BatchNorm2d(dim, eps=1e-5, momentum=0.1)
        super().__init__(bn(), nn.Conv2d(dim, dim, 3, padding=1), bn(),
                         nn.ReLU(), nn.Conv2d(dim, dim, 3, padding=1), bn(),
                         nn.ReLU(), nn.Conv2d(dim, dim, 1), nn.ReLU())
        self.dtype = dtype

    def _batch_norm(self, mod, x, update_stats):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, mod.running_mean, mod.running_var,
                                mod.weight, mod.bias, False, 0.0, mod.eps)
        # Flax's train mode: the biased batch statistics in fp32, the
        # variance as E[x^2] - E[x]^2 clipped at 0 (use_fast_variance);
        # F.batch_norm would update running_var with the unbiased n/(n-1)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        if update_stats:
            # the running stats are buffers: updated in place, outside
            # autograd, ra = (1 - m) ra + m stat (Flax: 0.9 ra + 0.1 stat)
            with torch.no_grad():
                m = mod.momentum
                mod.running_mean.copy_((1 - m) * mod.running_mean + m * mean)
                mod.running_var.copy_((1 - m) * mod.running_var + m * var)
                mod.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + mod.eps) * mod.weight
        return (x - mean.view(shape)) * mul.view(shape) + mod.bias.view(shape)

    def forward(self, x, update_stats: bool = True):
        """``update_stats=False`` leaves the running stats alone in train
        mode (an activation-checkpoint recompute of the same forward)."""
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
        for mod in self:
            cd = _compute_dtype(self.dtype, x)
            if isinstance(mod, nn.BatchNorm2d):
                x = self._batch_norm(mod, x, update_stats).to(cd)
            elif isinstance(mod, nn.Conv2d):
                x = F.conv2d(x.to(cd), mod.weight.to(cd), mod.bias.to(cd),
                             mod.stride, mod.padding)
            else:
                x = mod(x)
        return x.permute(0, 2, 3, 1)
