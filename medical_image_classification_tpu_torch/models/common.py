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

import math

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


def lecun_normal_(w, fan_in: int, generator=None):
    """Flax's default kernel init (``lecun_normal``): a normal of variance
    1 / fan_in cut at +-2 std, the std corrected for the cut."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
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
    """fp32 statistics and fp32 output (Flax LayerNorm, fp32 params); fp64
    stays fp64."""
    return F.layer_norm(x.to(_compute_dtype(None, x)), mod.normalized_shape,
                        mod.weight, mod.bias, mod.eps)


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
    """4x4 conv patchify (of RGB, or ``in_chans`` channels) + LayerNorm.
    NHWC in/out."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4, dtype=None,
                 in_chans: int = 3):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
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


class PatchExpand(nn.Module):
    """Upsample by ``dim_scale`` in NHWC: a bias-free Linear dim -> s dim,
    a pixel shuffle into dim / s channels at s x the side, LayerNorm.  The
    LayerNorm returns fp32 (a bare Flax LayerNorm, eps 1e-6), as the JAX
    module does; the caller's next Linear casts."""

    def __init__(self, dim: int, dim_scale: int = 2, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.dim_scale = dim_scale
        self.expand = nn.Linear(dim, dim_scale * dim, bias=False)
        # parity: Flax's LayerNorm eps
        self.norm = nn.LayerNorm(dim // dim_scale, eps=1e-6)

    def forward(self, x):
        b, h, w, c = x.shape
        s = self.dim_scale
        x = linear(self.expand, x, self.dtype)
        # [b, h, w, s, s, c / s] -> [b, h, s, w, s, c / s]
        x = x.reshape(b, h, w, s, s, c // s).permute(0, 1, 3, 2, 4, 5)
        return layer_norm(self.norm, x.reshape(b, h * s, w * s, c // s))


class FinalPatchExpand(PatchExpand):
    """The fusion decoder's x4 upsample: a Linear dim -> 4 dim shuffled
    4 x 4 into dim / 4 channels, LayerNorm (fp32 out)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__(dim, dim_scale=4, dtype=dtype)


def batch_norm(mod: nn.modules.batchnorm._BatchNorm, x, training: bool,
               update_stats: bool = True):
    """``mod`` on an NCHW (or [B, C]) tensor, in fp32, returned in fp32
    (Flax's BatchNorm with fp32 parameters).  Eval normalises with the running
    stats.  Train uses Flax's batch statistics: biased, the variance as
    E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance``; F.batch_norm
    would update running_var with the unbiased n/(n-1)); the running stats
    move by ``mod.momentum`` unless ``update_stats`` is False (an
    activation-checkpoint recompute of the same forward).  fp64 stays
    fp64."""
    x = x.to(_compute_dtype(None, x))
    if not training:
        return F.batch_norm(x, mod.running_mean, mod.running_var,
                            mod.weight, mod.bias, False, 0.0, mod.eps)
    dims = (0,) + tuple(range(2, x.dim()))
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
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + mod.eps) * mod.weight
    return (x - mean.view(shape)) * mul.view(shape) + mod.bias.view(shape)


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

    def forward(self, x, update_stats: bool = True):
        """``update_stats=False`` leaves the running stats alone in train
        mode (an activation-checkpoint recompute of the same forward)."""
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
        for mod in self:
            cd = _compute_dtype(self.dtype, x)
            if isinstance(mod, nn.BatchNorm2d):
                x = batch_norm(mod, x, self.training, update_stats).to(cd)
            elif isinstance(mod, nn.Conv2d):
                x = F.conv2d(x.to(cd), mod.weight.to(cd), mod.bias.to(cd),
                             mod.stride, mod.padding)
            else:
                x = mod(x)
        return x.permute(0, 2, 3, 1)


class ConvTConvPW(nn.Module):
    """CNN-Mamba's pre-stem on raw RGB, in fp32: BN -> 3x3 conv -> BN ->
    ReLU -> 5x5 conv -> + input -> 1x1 conv.  ONE BatchNorm at both of its
    call sites, as in the reference, so in train mode its running stats
    move twice a forward, one after the other.  NHWC in/out; the children
    carry the reference's names (``conv_T_conv.{bn,conv1,conv2,PW_conv}``
    in the model)."""

    def __init__(self, channels: int = 3):
        super().__init__()
        c = channels
        self.bn = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 5, padding=2)
        self.PW_conv = nn.Conv2d(c, c, 1)

    def forward(self, x):
        identity = x = x.float().permute(0, 3, 1, 2)
        x = self.conv1(batch_norm(self.bn, x, self.training))
        x = F.relu(batch_norm(self.bn, x, self.training))
        x = self.conv2(x) + identity
        return self.PW_conv(x).permute(0, 2, 3, 1)


class ECALayer(nn.Module):
    """Efficient channel attention: global average pool -> 1-D conv over
    the channel axis (k 3, no bias) -> sigmoid gate, in fp32 (float64 for
    a float64 stream), the gate cast to the activation's dtype.  NHWC
    in/out."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, 3, padding=1, bias=False)

    def reset_parameters(self, generator=None):
        # no kernel_init in the JAX module: Flax's lecun_normal, fan_in 3
        lecun_normal_(self.conv.weight, 3, generator)

    def forward(self, x):
        y = x.to(_compute_dtype(None, x)).mean(dim=(1, 2))[:, None, :]
        y = torch.sigmoid(self.conv(y)[:, 0])
        return x * y.to(x.dtype)[:, None, None, :]


class MIFABlock(nn.Module):
    """Local/global feature interaction: a depthwise 3x3 conv (ReLU) and a
    1x1 conv (tanh GELU, Flax's ``nn.gelu``) gate each other through
    sigmoids; concat, channel shuffle, 1x1 merge, ECA, + input.  Its convs
    have no compute dtype in the JAX module, so they run in fp32 and a bf16
    stream leaves the block in fp32.  NHWC in/out."""

    def __init__(self, dim: int):
        super().__init__()
        self.dw = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.pw = nn.Conv2d(dim, dim, 1)
        self.merge = nn.Conv2d(2 * dim, dim, 1)
        self.eca = ECALayer()

    def forward(self, x):
        local = F.relu(conv_nhwc(self.dw, x))
        glob = F.gelu(conv_nhwc(self.pw, x), approximate="tanh")
        a = local * torch.sigmoid(glob)
        b = glob * torch.sigmoid(local)
        out = channel_shuffle(torch.cat([a, b], dim=-1), 2)
        return self.eca(conv_nhwc(self.merge, out)) + x
