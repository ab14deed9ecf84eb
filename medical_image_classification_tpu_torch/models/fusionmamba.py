"""FusionMamba: the EfficientScan U-Net for CT/MRI image fusion.

Port of ``medical_image_classification_tpu/models/fusionmamba.py``:

* ``efficient_scan_core``: EfficientScan, the per-sub-sequence Δ/B/C
  projections, the Mamba-1 selective scan over the four strided
  sub-sequences folded into the sequence axis ([B * 4, L / 4, D], the
  parameter group k = g % 4) and EfficientMerge.
* ``SS2DEfficient`` / ``SS2DCrossEfficient``: the single- and two-input
  scan layers around it (the cross layer fuses x = xa xb + xa + xb before
  one scan and gates with both branches).
* ``LDCConv``, ``DifferentialEnhance``, ``CrossLayer``, ``BiAttn``: the
  learnable-difference conv, the difference-gated fuse injection, the
  texture + difference enhancement and the global channel gate.
* ``VSSBlockNew`` / ``VSSBlockCrossNew``: the encoder/decoder block and the
  per-stage cross-fusion block.
* ``VSSMFusion``: one encoder applied to both inputs (two patch embeds),
  a cross block per stage on the skips, the decoder with additive skips
  and ``PatchExpand``, ``FinalPatchExpand``, a 1x1 conv in fp32 and the
  reference's 2 (in1 + in2) residual.
* ``CDCConvHV`` / ``CDCConvDiag``: the central-difference convs of the
  reference file (no model calls them).

Activations are NHWC.  Parameters are fp32; ``dtype`` is the compute dtype
of the linears and convolutions.  The module trees carry the reference
``state_dict`` names that
``utils/torch_import.py::import_vssm_fusion_state_dict`` reads: the scan
parameters sit on the scan layer itself, ``A_logs`` [4 D, N] and ``Ds``
[4 D]; the LDC's ``learnable_mask`` is [out, in].  A float64 model (the
exact reference of a gradient check) runs the plain scan in float64 under
torch.autograd (``scan_folded_fwd``'s float64 case).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
)
from medical_image_classification_tpu_torch.models.common import (
    DropPath,
    ECALayer,
    FinalPatchExpand,
    PatchEmbed,
    PatchExpand,
    PatchMerging,
    SeededGenerators,
    conv_nhwc,
    kaiming_conv_,
    layer_norm,
    lecun_normal_,
    linear,
)
from medical_image_classification_tpu_torch.models.ss2d_modules import (
    K,
    a_log_init_s4d_,
    dt_bias_init_,
    torch_linear_rowmajor_,
    uniform_pm_,
)
from medical_image_classification_tpu_torch.models.vssm import (
    reset_parameters,
)
from medical_image_classification_tpu_torch.ops.cross_scan import (
    efficient_merge,
    efficient_scan,
)


def efficient_scan_core(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds, *,
                        d_state: int, dt_rank: int, impl: str = "auto"):
    """EfficientScan -> per-K projection -> selective scan ->
    EfficientMerge: [B, H, W, D] -> [B, H, W, D] in x's dtype.

    x_proj_w [4, dt_rank + 2 d_state, D], dt_proj_w [4, D, dt_rank],
    dt_proj_b and Ds [4, D], A_log [4, D, d_state].  The Δ projection is
    the JAX package's two stages (weights cast to x's dtype).  The four
    sub-sequences scan in raster order through ``scan_folded_fwd`` (the
    row-1/row-2 kernels on the card, by ``impl``)."""
    Bb, H, W, D = x.shape
    xs = efficient_scan(x)                             # [B, 4, L4, D]
    L4 = xs.shape[2]
    x_dbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w.to(xs.dtype))
    dts = torch.einsum("bklr,kdr->bkld", x_dbl[..., :dt_rank],
                       dt_proj_w.to(xs.dtype))
    Bm = x_dbl[..., dt_rank:dt_rank + d_state]
    Cm = x_dbl[..., dt_rank + d_state:]
    fold = lambda t: t.reshape(Bb * K, L4, t.shape[-1]).contiguous()
    y = scan_folded_fwd(fold(xs), fold(dts), -torch.exp(A_log), fold(Bm),
                        fold(Cm), Ds, dt_proj_b, reverse=False, impl=impl)
    return efficient_merge(y.reshape(Bb, K, L4, D), H, W)


class _ScanParams(nn.Module):
    """The scan parameters of the efficient-scan layers, under the
    reference's names: ``x_proj_weight`` [4, R + 2N, D], ``dt_projs_weight``
    [4, D, R], ``dt_projs_bias`` [4, D], ``A_logs`` [4 D, N], ``Ds`` [4 D]."""

    def _scan_params(self, d_inner: int, d_state: int, dt_rank: int):
        self.d_inner, self.d_state, self.dt_rank = d_inner, d_state, dt_rank
        self.x_proj_weight = nn.Parameter(
            torch.empty(K, dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, d_inner, dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K * d_inner, d_state))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))

    def reset_scan_parameters(self, generator=None):
        torch_linear_rowmajor_(self.x_proj_weight, generator)
        uniform_pm_(self.dt_projs_weight, self.dt_rank ** -0.5, generator)
        dt_bias_init_(self.dt_projs_bias, generator)
        a_log_init_s4d_(self.A_logs)
        nn.init.ones_(self.Ds)

    def _scan(self, x):
        return efficient_scan_core(
            x, self.x_proj_weight, self.dt_projs_weight, self.dt_projs_bias,
            self.A_logs.view(K, self.d_inner, self.d_state),
            self.Ds.view(K, self.d_inner), d_state=self.d_state,
            dt_rank=self.dt_rank, impl=self.scan_impl)


class SS2DEfficient(_ScanParams):
    """Single-input SS2D over the strided sub-sequences: in_proj -> x, z;
    depthwise 3x3 conv -> SiLU -> the scan -> out_norm (fp32, eps 1e-6)
    -> * silu(z) -> out_proj.  d_expand is 2 d_model, dt_rank
    ceil(d_model / 16)."""

    def __init__(self, d_model: int, d_state: int = 16,
                 scan_impl: str = "auto", dtype=None):
        super().__init__()
        d_expand = 2 * d_model
        self.scan_impl, self.dtype = scan_impl, dtype
        self.in_proj = nn.Linear(d_model, 2 * d_expand, bias=False)
        self.conv2d = nn.Conv2d(d_expand, d_expand, 3, groups=d_expand,
                                padding=1)
        self._scan_params(d_expand, d_state, math.ceil(d_model / 16))
        self.out_norm = nn.LayerNorm(d_expand, eps=1e-6)  # parity: Flax eps
        self.out_proj = nn.Linear(d_expand, d_model, bias=False)

    def forward(self, x):
        dt = self.dtype
        xp, z = linear(self.in_proj, x, dt).chunk(2, dim=-1)
        xp = F.silu(conv_nhwc(self.conv2d, xp, dt))
        y = layer_norm(self.out_norm, self._scan(xp).to(x.dtype))
        return linear(self.out_proj, y * F.silu(z), dt)


class SS2DCrossEfficient(_ScanParams):
    """Two-input SS2D: each input's in_proj gives (x, z); one depthwise
    conv (shared) and SiLU on both x; the content fuse x = xa xb + xa + xb;
    one scan; out_norm; the gate y z1 + y z2; out_proj.  z2 is silu(z1),
    the reference's slip (the second branch's z is computed and unused)."""

    def __init__(self, d_model: int, d_state: int = 16,
                 scan_impl: str = "auto", dtype=None):
        super().__init__()
        d_expand = 2 * d_model
        self.scan_impl, self.dtype = scan_impl, dtype
        self.in_proj1 = nn.Linear(d_model, 2 * d_expand, bias=False)
        self.in_proj2 = nn.Linear(d_model, 2 * d_expand, bias=False)
        self.conv2d = nn.Conv2d(d_expand, d_expand, 3, groups=d_expand,
                                padding=1)
        self._scan_params(d_expand, d_state, math.ceil(d_model / 16))
        self.out_norm = nn.LayerNorm(d_expand, eps=1e-6)  # parity: Flax eps
        self.out_proj = nn.Linear(d_expand, d_model, bias=False)

    def forward(self, x1, x2):
        dt = self.dtype
        xa, z1 = linear(self.in_proj1, x1, dt).chunk(2, dim=-1)
        xb = linear(self.in_proj2, x2, dt).chunk(2, dim=-1)[0]
        z1 = F.silu(z1)
        z2 = z1                                    # the reference's slip
        xa = F.silu(conv_nhwc(self.conv2d, xa, dt))
        xb = F.silu(conv_nhwc(self.conv2d, xb, dt))
        y = layer_norm(self.out_norm,
                       self._scan(xa * xb + xa + xb).to(x1.dtype))
        return linear(self.out_proj, y * z1 + y * z2, dt)


class LDCConv(nn.Module):
    """Learnable-difference 3x3 conv, no bias: the weight times the mask
    1 - theta * center * learnable_mask * (the kernel's spatial sum), in
    the input's dtype.  ``learnable_mask`` is [out, in], as the reference
    stores it."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 3, padding=1,
                              bias=False)
        self.learnable_mask = nn.Parameter(torch.ones(features, in_features))
        self.learnable_theta = nn.Parameter(torch.full((1,), 0.5))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.learnable_mask)
        nn.init.constant_(self.learnable_theta, 0.5)

    def forward(self, x):
        w = self.conv.weight                          # [out, in, k, k]
        k = w.shape[-1]
        center = torch.zeros(k, k, dtype=w.dtype, device=w.device)
        center[k // 2, k // 2] = 1.0
        ksum = w.sum(dim=(2, 3))                      # [out, in]
        mask = 1.0 - self.learnable_theta * center * \
            (self.learnable_mask * ksum)[..., None, None]
        y = F.conv2d(x.permute(0, 3, 1, 2), (w * mask).to(x.dtype),
                     padding=1)
        return y.permute(0, 2, 3, 1)


class DifferentialEnhance(nn.Module):
    """Difference-gated fuse injection: x1 + sigmoid(mean(x1 - x2)) fuse,
    x2 + sigmoid(mean(x2 - x1)) fuse (means over the spatial axes)."""

    def forward(self, fuse, x1, x2):
        w12 = torch.sigmoid((x1 - x2).mean(dim=(1, 2), keepdim=True))
        w21 = torch.sigmoid((x2 - x1).mean(dim=(1, 2), keepdim=True))
        return x1 + w12 * fuse, x2 + w21 * fuse


class CrossLayer(nn.Module):
    """Texture (an LDC conv per input) + differential enhancement."""

    def __init__(self, dim: int):
        super().__init__()
        self.texture_enhance1 = LDCConv(dim, dim)
        self.texture_enhance2 = LDCConv(dim, dim)
        self.diff_enhance = DifferentialEnhance()

    def forward(self, fuse, x1, x2):
        d1, d2 = self.diff_enhance(fuse, x1, x2)
        return self.texture_enhance1(x1) + d1, self.texture_enhance2(x2) + d2


class BiAttn(nn.Module):
    """Global channel gate, in fp32: LayerNorm (eps 1e-6), the spatial mean,
    Linear to max(1, C // 8), exact-erf GELU, Linear back, sigmoid; x
    times the gate cast to x's dtype.  The two linears take Flax's default
    init (lecun_normal, zero bias)."""

    def __init__(self, dim: int):
        super().__init__()
        red = max(1, dim // 8)
        self.norm = nn.LayerNorm(dim, eps=1e-6)          # parity: Flax eps
        self.global_reduce = nn.Linear(dim, red)
        self.channel_select = nn.Linear(red, dim)

    def reset_parameters(self, generator=None):
        self.norm.reset_parameters()
        for lin in (self.global_reduce, self.channel_select):
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x):
        g = layer_norm(self.norm, x).mean(dim=(1, 2), keepdim=True)
        g = F.gelu(linear(self.global_reduce, g))
        attn = torch.sigmoid(linear(self.channel_select, g))
        return x * attn.to(x.dtype)


class VSSBlockNew(nn.Module):
    """The encoder/decoder block:

        h = LN(x); y_ssm = SS2DEfficient(h); y = y_ssm + ECA(y_ssm)
        y_conv = LDC(y); out = x + droppath(se(y_ssm) + se(y_conv))
        out = out + droppath(mlp(LN2(out)))         # 4x, exact GELU

    ``se`` is one BiAttn applied to both branches; the ECA is named
    ``self_attention_cross_channel`` as in the reference."""

    def __init__(self, dim: int, d_state: int = 16, drop_path: float = 0.0,
                 scan_impl: str = "auto", dtype=None,
                 rng: SeededGenerators | None = None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(dim, eps=1e-6)          # parity: Flax eps
        self.op = SS2DEfficient(dim, d_state=d_state, scan_impl=scan_impl,
                                dtype=dtype)
        self.self_attention_cross_channel = ECALayer()
        self.conv_branch = LDCConv(dim, dim)
        self.se = BiAttn(dim)
        self.drop_path = DropPath(drop_path, rng=rng)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        dt = self.dtype
        y_ssm = self.op(layer_norm(self.norm, x).to(x.dtype))
        y = y_ssm + self.self_attention_cross_channel(y_ssm)
        y_conv = self.conv_branch(y)
        out = x + self.drop_path(self.se(y_ssm) + self.se(y_conv))
        h = layer_norm(self.norm2, out).to(out.dtype)
        h = F.gelu(linear(self.mlp.fc1, h, dt))
        return out + self.drop_path(linear(self.mlp.fc2, h, dt))


class VSSBlockCrossNew(nn.Module):
    """The cross-fusion block: CrossLayer enhancement of (x1, x2) around
    their sum, LN on each, SS2DCrossEfficient, an ECA
    (``self_attention_cross_spatial``), and x1 + x2 + y + ECA(y)."""

    def __init__(self, dim: int, d_state: int = 16, scan_impl: str = "auto",
                 dtype=None):
        super().__init__()
        self.Cross_layer = CrossLayer(dim)
        self.ln_1 = nn.LayerNorm(dim, eps=1e-6)          # parity: Flax eps
        self.ln_2 = nn.LayerNorm(dim, eps=1e-6)
        self.self_attention_cross = SS2DCrossEfficient(
            dim, d_state=d_state, scan_impl=scan_impl, dtype=dtype)
        self.self_attention_cross_spatial = ECALayer()

    def forward(self, x1, x2):
        f1, f2 = self.Cross_layer(x1 + x2, x1, x2)
        f1 = layer_norm(self.ln_1, f1).to(x1.dtype)
        f2 = layer_norm(self.ln_2, f2).to(x2.dtype)
        y = self.self_attention_cross(f1, f2)
        return x1 + x2 + y + self.self_attention_cross_spatial(y)


class _Stage(nn.Module):
    """A stage's blocks with its ``downsample`` (encoder) or ``upsample``
    (decoder), as the reference nests them."""

    def __init__(self, blocks, downsample=None, upsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample
        if upsample is not None:
            self.upsample = upsample


class VSSMFusion(nn.Module):
    """The FusionMamba U-Net: (x1, x2) NHWC [B, H, W, 1] -> the fused image
    [B, H, W, 1] in fp32.

    ``patch_embed1`` / ``patch_embed2`` embed the two inputs; one encoder
    (``layers``: the blocks and a PatchMerging after every stage but the
    last) runs on each, its gradient the sum of both uses; the bottoms are
    summed; ``Cross_block.{i}`` fuses the two skips of stage i; the decoder
    (``layers_up``) adds the fused skip of stage nl - i and upsamples
    before every stage i but the first.  So nothing reads stage 0's fused
    skip: ``Cross_block.0`` is in the model (and the reference's
    state_dict) but is not run, and its parameters get no gradient (zeros
    in the JAX package, whose compiled step drops it too).  Then
    ``final_up`` (x4), the 1x1 ``final_conv`` in fp32, and the reference's
    2 (x1 + x2) residual.  The drop-path rates are a linspace over the
    encoder's blocks and the same over the decoder's, reversed.  Every
    side must stay even down to the last stage (EfficientScan's step 2).
    The inputs have one channel and the patch is 4x4."""

    def __init__(self, depths: Sequence[int] = (2, 2, 9, 2),
                 depths_decoder: Sequence[int] = (2, 9, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 dims_decoder: Sequence[int] = (768, 384, 192, 96),
                 d_state: int = 16, drop_path_rate: float = 0.1,
                 scan_impl: str = "auto", dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        nl = len(depths)
        self.dtype = dtype
        self.drop_path_rng = rng = SeededGenerators(0)
        blk = dict(d_state=d_state, scan_impl=scan_impl, dtype=dtype,
                   rng=rng)
        self.patch_embed1 = PatchEmbed(dims[0], 4, dtype, in_chans=1)
        self.patch_embed2 = PatchEmbed(dims[0], 4, dtype, in_chans=1)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            _Stage([VSSBlockNew(dims[i], drop_path=dpr[sum(depths[:i]) + j],
                                **blk) for j in range(depths[i])],
                   downsample=(PatchMerging(dims[i], dtype=dtype)
                               if i < nl - 1 else None))
            for i in range(nl))
        self.Cross_block = nn.ModuleList(
            VSSBlockCrossNew(dims[i], d_state=d_state, scan_impl=scan_impl,
                             dtype=dtype) for i in range(nl))
        dpr_d = np.linspace(0, drop_path_rate,
                            sum(depths_decoder)).tolist()[::-1]
        self.layers_up = nn.ModuleList(
            _Stage([VSSBlockNew(dims_decoder[i],
                                drop_path=dpr_d[sum(depths_decoder[:i]) + j],
                                **blk) for j in range(depths_decoder[i])],
                   upsample=(PatchExpand(dims_decoder[i - 1], dtype=dtype)
                             if i > 0 else None))
            for i in range(nl))
        self.final_up = FinalPatchExpand(dims_decoder[-1], dtype=dtype)
        self.final_conv = nn.Conv2d(dims_decoder[-1] // 4, 1, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """The JAX package's init distributions, drawn from ``generator``:
        ``models/vssm.py::reset_parameters``, then the BiAttn linears'
        lecun_normal and the LDC masks."""
        reset_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, (BiAttn, LDCConv)):
                m.reset_parameters(generator)

    def seed_drop_path(self, seed: int):
        """Restart every DropPath mask stream from ``seed``."""
        self.drop_path_rng.manual_seed(seed)

    def _encode(self, h):
        skips = []
        for stage in self.layers:
            skips.append(h)
            for blk in stage.blocks:
                h = blk(h)
            if hasattr(stage, "downsample"):
                h = stage.downsample(h)
        return h, skips

    def forward(self, x1, x2):
        in1, in2 = x1, x2
        if self.dtype is not None:
            x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
        h1, skips1 = self._encode(self.patch_embed1(x1))
        h2, skips2 = self._encode(self.patch_embed2(x2))
        h = h1 + h2
        nl = len(self.layers)
        for i, stage in enumerate(self.layers_up):
            if i > 0:
                j = nl - i
                h = stage.upsample(h + self.Cross_block[j](skips1[j],
                                                            skips2[j]))
            for blk in stage.blocks:
                h = blk(h)
        # the 1x1 conv has no compute dtype in the JAX module: fp32 (fp64
        # in the float64 reference); the reference adds the inputs twice
        out = conv_nhwc(self.final_conv, self.final_up(h))
        return out + 2.0 * (in1 + in2)


class _CDCConv(nn.Module):
    """Central-difference 3x3 conv from 5 learned taps placed by
    ``_layout`` (no bias): conv(x, k) - theta conv(x, sum of k), in x's
    dtype, theta 0.7.  ``taps`` is [out, in, 1, 5]."""

    _layout: tuple = ()
    theta = 0.7

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.taps = nn.Parameter(torch.empty(features, in_features, 1, 5))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        kaiming_conv_(self.taps, generator)

    def forward(self, x):
        o, i = self.taps.shape[:2]
        k = self.taps.new_zeros(o, i, 9)
        k[..., list(self._layout)] = self.taps[:, :, 0]
        k = k.reshape(o, i, 3, 3).to(x.dtype)
        xc = x.permute(0, 3, 1, 2)
        out = F.conv2d(xc, k, padding=1) - self.theta * F.conv2d(
            xc, k.sum(dim=(2, 3), keepdim=True))
        return out.permute(0, 2, 3, 1)


class CDCConvHV(_CDCConv):
    """Horizontal/vertical cross: [0 t0 0 / t1 t2 t3 / 0 t4 0]."""
    _layout = (1, 3, 4, 5, 7)


class CDCConvDiag(_CDCConv):
    """Diagonal cross: [t0 0 t1 / 0 t2 0 / t3 0 t4]."""
    _layout = (0, 2, 4, 6, 8)
