"""The CrossMamba family: dual-input classifiers and fusion U-Nets.

Port of ``medical_image_classification_tpu/models/crossmamba.py``:

* ``CrossMamba``: the dual-input SSD core.  Both branches share every
  projection; each scans its own x but draws B, C and dt from the cross
  input.  Its SSD runs through ``ops/ss2d.py::ss2d_core_ssd`` (the dirs
  kernels, or the einsum path with Y_diag, by the card's gates).
* ``DownLayer`` / ``UpLayer`` / ``UpLayerSingle``: the fusion U-Net's
  stages.  The two branches' blocks are two plain module lists
  (``blocks1``, ``blocks2``), each block with its own BatchNorm statistics
  over its own branch's batch, as the JAX package's vmapped pair computes.
* ``FusionVFEFM``: the CT/MRI fusion U-Net (two images -> one fused
  image [B, H, W, 1] in fp32); ``single_decoder`` is the ``_2c1`` wiring.
* ``CrossVSSMClassifier``: the dual-branch classifier, ``fuse_mode``
  "stage3", "stage3_merged" or "all".

Activations are NHWC.  Parameters are fp32; ``dtype`` is the compute dtype
of the linears and convolutions, as ``dtype`` on the Flax modules.  The
module trees carry the reference ``state_dict`` names that
``utils/torch_import.py::import_cross_classifier_state_dict`` and
``import_vfefm_state_dict`` read.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_classification_tpu_torch.models.common import (
    FinalPatchExpand,
    PatchEmbed,
    PatchExpand,
    PatchMerging,
    SeededGenerators,
    conv_nhwc,
    layer_norm,
    linear,
)
from medical_image_classification_tpu_torch.models.ss2d_modules import (
    K,
    RMSNormGated,
    a_log_init_uniform_,
    dt_bias_init_,
)
from medical_image_classification_tpu_torch.models.vssm import (
    SSConvBlock,
    VSSLayer,
    reset_parameters,
)
from medical_image_classification_tpu_torch.ops.ss2d import (
    rmsnorm_gated,
    ss2d_core_ssd,
)


# every CrossMamba fusion's d_state (the reference's CrossMamba default,
# whatever the model's d_state): a state K x 128 = 512 wide
FUSION_D_STATE = 128


class CrossMamba(nn.Module):
    """Dual-input SSD core with cross parameterisation (NHWC in and out).

    ``forward(u1, u2, c1, c2)`` returns (branch(u1, c1), branch(u2, c2)):
    a branch takes its x (depthwise 3x3 conv + SiLU) and its gate z from
    ``u_own`` and B, C, dt from ``u_cross``, scans [x | B | C | dt] in four
    directions (one B/C group, the state K d_state wide), then the gated
    RMSNorm and out_proj.  The JAX module's settings in every caller:
    expand 2, all of d_inner scanned (so no MLP half), one group, RMSNorm
    on, conv bias only, no dropout (the JAX module's ``dropout`` is 0 in
    every caller; not ported).  ``A_logs`` and ``Ds`` are stored as [K * nheads],
    ``dt_bias`` as [K, nheads], as in the reference ``state_dict``.  The
    reference's unused ``in_proj`` / ``conv2d`` pair is not built."""

    def __init__(self, d_model: int, d_state: int = FUSION_D_STATE,
                 headdim: int = 64, scan_impl: str = "auto", dtype=None):
        super().__init__()
        self.d_ssm = d_ssm = 2 * d_model                   # expand 2
        self.headdim = headdim
        self.nheads = nheads = d_ssm // headdim
        self.d_state = d_state
        self.scan_impl = scan_impl
        self.dtype = dtype
        d_bc = 2 * d_state + nheads
        self.skip_in_proj = nn.Linear(d_model, d_ssm, bias=False)
        self.xs_in_proj = nn.Linear(d_model, d_ssm, bias=False)
        self.BCdts_in_proj = nn.Linear(d_model, d_bc, bias=False)
        self.xs_conv2d = nn.Conv2d(d_ssm, d_ssm, 3, groups=d_ssm, padding=1)
        self.BCdts_conv2d = nn.Conv2d(d_bc, d_bc, 3, groups=d_bc, padding=1)
        self.dt_bias = nn.Parameter(torch.empty(K, nheads))
        self.A_logs = nn.Parameter(torch.empty(K * nheads))
        self.Ds = nn.Parameter(torch.ones(K * nheads))
        self.norm = RMSNormGated(d_ssm)
        self.out_proj = nn.Linear(d_ssm, d_model, bias=False)

    def reset_scan_parameters(self, generator=None):
        a_log_init_uniform_(self.A_logs, generator)
        dt_bias_init_(self.dt_bias, generator)
        nn.init.ones_(self.Ds)
        nn.init.ones_(self.norm.weight)

    def branch(self, u_own, u_cross):
        dt = self.dtype
        z = linear(self.skip_in_proj, u_own, dt)
        xs = F.silu(conv_nhwc(self.xs_conv2d,
                              linear(self.xs_in_proj, u_own, dt), dt))
        bcdt = F.silu(conv_nhwc(self.BCdts_conv2d,
                                linear(self.BCdts_in_proj, u_cross, dt), dt))
        y = ss2d_core_ssd(
            torch.cat([xs, bcdt], dim=-1), self.A_logs.view(K, self.nheads),
            self.dt_bias, self.Ds.view(K, self.nheads), d_ssm=self.d_ssm,
            d_state=self.d_state, nheads=self.nheads, headdim=self.headdim,
            chunk_size=256, impl=self.scan_impl)
        y = rmsnorm_gated(y.to(u_own.dtype), z, self.norm.weight)
        return linear(self.out_proj, y, dt)

    def forward(self, u1, u2, c1, c2):
        return self.branch(u1, c1), self.branch(u2, c2)


def cat_inputs(x1, x2, method: str, proj: nn.Linear | None, dtype=None):
    """The cross inputs (c1, c2) of a fusion: "none" swaps the branches,
    "add" gives both their sum, "stack" both ``proj`` of their concat."""
    if method == "add":
        s = x1 + x2
        return s, s
    if method == "stack":
        u = linear(proj, torch.cat([x1, x2], dim=-1), dtype)
        return u, u
    return x2, x1


def _cat_proj(dim: int, method: str):
    return nn.Linear(2 * dim, dim) if method == "stack" else None


def _blocks(dim: int, drop_paths: Sequence[float], **kw):
    return nn.ModuleList(SSConvBlock(dim, drop_path=dp, core="ssd", **kw)
                         for dp in drop_paths)


class _FusedStage(nn.Module):
    """What the U-Net's stages (and the classifier's "all" stages) share:
    each branch's SS-Conv-SSD blocks, the cat_method merge and CrossMamba
    with a residual."""

    def _build(self, dim, drop_paths, cat_method, blk):
        self.cat_method = cat_method
        self.dtype = blk.get("dtype")
        self.blocks1 = _blocks(dim, drop_paths, **blk)
        self.blocks2 = _blocks(dim, drop_paths, **blk)
        self.cat_proj = _cat_proj(dim, cat_method)
        self.fusion = CrossMamba(dim, headdim=blk["ssd_headdim"],
                                 scan_impl=blk["scan_impl"],
                                 dtype=self.dtype)

    def _blocks_and_fusion(self, x1, x2):
        """(the blocks' outputs, the fused outputs with the residual)."""
        for b1, b2 in zip(self.blocks1, self.blocks2):
            x1, x2 = b1(x1), b2(x2)
        c1, c2 = cat_inputs(x1, x2, self.cat_method, self.cat_proj,
                            self.dtype)
        f1, f2 = self.fusion(x1, x2, c1, c2)
        return (x1, x2), (x1 + f1, x2 + f2)


class DownLayer(_FusedStage):
    """Encoder stage of the fusion U-Net (and a stage of the classifier's
    "all" mode): the fused stage, then each branch's PatchMerging.
    Returns (f1, f2, skip), skip the blocks' outputs before the fusion."""

    def __init__(self, dim: int, drop_paths: Sequence[float],
                 cat_method: str = "stack", downsample: bool = True, **blk):
        super().__init__()
        self._build(dim, drop_paths, cat_method, blk)
        self.downsample1 = self.downsample2 = None
        if downsample:
            self.downsample1 = PatchMerging(dim, dtype=self.dtype)
            self.downsample2 = PatchMerging(dim, dtype=self.dtype)

    def forward(self, x1, x2):
        skip, (f1, f2) = self._blocks_and_fusion(x1, x2)
        if self.downsample1 is not None:
            f1, f2 = self.downsample1(f1), self.downsample2(f2)
        return f1, f2, skip


class UpLayer(_FusedStage):
    """Decoder stage of the dual decoder: each branch's PatchExpand (from
    ``in_dim`` channels), the skip concat and ``in_proj{b}``, then the
    fused stage."""

    def __init__(self, dim: int, drop_paths: Sequence[float], in_dim: int,
                 skip_dim: int | None, upsample: bool = True,
                 cat_method: str = "stack", **blk):
        super().__init__()
        dt = blk.get("dtype")
        self.upsample1 = self.upsample2 = None
        if upsample:
            self.upsample1 = PatchExpand(in_dim, dtype=dt)
            self.upsample2 = PatchExpand(in_dim, dtype=dt)
            in_dim //= 2
        self.in_proj1 = self.in_proj2 = None
        if skip_dim is not None:
            self.in_proj1 = nn.Linear(in_dim + skip_dim, dim)
            self.in_proj2 = nn.Linear(in_dim + skip_dim, dim)
        self._build(dim, drop_paths, cat_method, blk)

    def forward(self, x1, x2, s1=None, s2=None):
        if self.upsample1 is not None:
            x1, x2 = self.upsample1(x1), self.upsample2(x2)
        if self.in_proj1 is not None:
            x1 = linear(self.in_proj1, torch.cat([x1, s1], dim=-1),
                        self.dtype)
            x2 = linear(self.in_proj2, torch.cat([x2, s2], dim=-1),
                        self.dtype)
        return self._blocks_and_fusion(x1, x2)[1]


class UpLayerSingle(nn.Module):
    """Decoder stage of the single decoder (``_2c1``): PatchExpand, the two
    skips folded by ``cat_down``, ``in_proj`` on the concat, the blocks.
    No decoder fusion."""

    def __init__(self, dim: int, drop_paths: Sequence[float], in_dim: int,
                 skip_dim: int | None, upsample: bool = True, **blk):
        super().__init__()
        self.dtype = dt = blk.get("dtype")
        self.upsample = None
        if upsample:
            self.upsample = PatchExpand(in_dim, dtype=dt)
            in_dim //= 2
        self.cat_down = self.in_proj = None
        if skip_dim is not None:
            self.cat_down = nn.Linear(2 * skip_dim, dim)
            self.in_proj = nn.Linear(in_dim + dim, dim)
        self.blocks = _blocks(dim, drop_paths, **blk)

    def forward(self, x, s1=None, s2=None):
        if self.upsample is not None:
            x = self.upsample(x)
        if self.in_proj is not None:
            sdown = linear(self.cat_down, torch.cat([s1, s2], dim=-1),
                           self.dtype)
            x = linear(self.in_proj, torch.cat([x, sdown], dim=-1),
                       self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x


def _stage_rates(rates, depths, i):
    return rates[sum(depths[:i]):sum(depths[:i + 1])]


class _TwoInput(nn.Module):
    """What the two models share: two patch embeds, the DropPath stream,
    the block settings, the seeded init."""

    def _setup(self, dims, d_state, ssd_headdim, scan_impl, dtype):
        self.dtype = dtype
        self.drop_path_rng = SeededGenerators(0)
        self.patch_embed1 = PatchEmbed(dims[0], dtype=dtype)
        self.patch_embed2 = PatchEmbed(dims[0], dtype=dtype)
        return dict(d_state=d_state, ssd_headdim=ssd_headdim,
                    scan_impl=scan_impl, dtype=dtype, rng=self.drop_path_rng)

    def reset_parameters(self, generator=None):
        """The JAX package's init distributions, drawn from ``generator``
        (``models/vssm.py::reset_parameters``)."""
        reset_parameters(self, generator)

    def seed_drop_path(self, seed: int):
        """Restart every DropPath mask stream from ``seed``."""
        self.drop_path_rng.manual_seed(seed)

    def _embed(self, x1, x2):
        if self.dtype is not None:
            x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
        return self.patch_embed1(x1), self.patch_embed2(x2)


class FusionVFEFM(_TwoInput):
    """Dual-branch image-fusion U-Net: (x1, x2) NHWC [B, H, W, 3] ->
    the fused image [B, H, W, 1] in fp32.

    Encoder: ``DownLayer`` per stage (skips collected).  Dual decoder: 1x1
    conv bridges, ``UpLayer`` per stage, LayerNorm on the branches' concat,
    ``final_cat_proj``, ``FinalPatchExpand`` and a 1x1 conv in fp32.
    ``single_decoder`` (``_2c1``): one Linear bridge on the concat, an
    ``UpLayerSingle`` per stage, ``FinalPatchExpand`` and the 1x1 conv (the
    reference file's unused norm and final_cat_proj are not built).  The
    encoder's and the decoder's drop-path rates are two linspaces."""

    def __init__(self, depths: Sequence[int] = (2, 2, 4, 2),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 depths_decoder: Sequence[int] = (2, 9, 2, 2),
                 dims_decoder: Sequence[int] = (1024, 512, 256, 128),
                 d_state: int = 128, ssd_headdim: int = 64,
                 cat_method: str = "stack",
                 drop_path_rate: float = 0.1, single_decoder: bool = False,
                 scan_impl: str = "auto", dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        blk = self._setup(dims, d_state, ssd_headdim, scan_impl, dtype)
        nl, nd = len(depths), len(depths_decoder)
        self.single_decoder = single_decoder
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            DownLayer(dims[i], _stage_rates(dpr, depths, i),
                      downsample=i < nl - 1, cat_method=cat_method, **blk)
            for i in range(nl))
        # each decoder stage's skip: the encoder stage at its post-upsample
        # size (the last stage, which does not upsample, reuses stage 0's)
        self.skip_index = [None] + [0 if j == nd - 1 else nd - 2 - j
                                    for j in range(1, nd)]
        dpr_d = np.linspace(0, drop_path_rate, sum(depths_decoder)).tolist()
        if single_decoder:
            self.bridge = nn.Linear(2 * dims[-1], dims_decoder[0])
        else:
            self.bridge1 = nn.Conv2d(dims[-1], dims_decoder[0], 1)
            self.bridge2 = nn.Conv2d(dims[-1], dims_decoder[0], 1)
        up = []
        ch = dims_decoder[0]
        for j in range(nd):
            ups = j < nd - 1
            dim = dims_decoder[j] // 2 if ups else dims_decoder[j]
            idx = self.skip_index[j]
            kw = dict(in_dim=ch, upsample=ups,
                      skip_dim=None if idx is None else dims[idx],
                      **blk)
            rates = _stage_rates(dpr_d, depths_decoder, j)
            up.append(UpLayerSingle(dim, rates, **kw) if single_decoder
                      else UpLayer(dim, rates, cat_method=cat_method, **kw))
            ch = dim
        self.layers_up = nn.ModuleList(up)
        if not single_decoder:
            self.norm = nn.LayerNorm(2 * ch, eps=1e-6)    # parity: Flax eps
            self.final_cat_proj = nn.Linear(2 * ch, dims_decoder[-1])
            ch = dims_decoder[-1]
        self.final_expand = FinalPatchExpand(ch, dtype=dtype)
        self.final_conv = nn.Conv2d(ch // 4, 1, 1)
        self.reset_parameters(generator)

    def forward(self, x1, x2):
        x1, x2 = self._embed(x1, x2)
        skips = []
        for layer in self.layers:
            x1, x2, skip = layer(x1, x2)
            skips.append(skip)
        dt = self.dtype
        if self.single_decoder:
            x = linear(self.bridge, torch.cat([x1, x2], dim=-1), dt)
            for layer, idx in zip(self.layers_up, self.skip_index):
                x = layer(x, *(() if idx is None else skips[idx]))
        else:
            x1, x2 = conv_nhwc(self.bridge1, x1, dt), \
                conv_nhwc(self.bridge2, x2, dt)
            for layer, idx in zip(self.layers_up, self.skip_index):
                x1, x2 = layer(x1, x2, *(() if idx is None else skips[idx]))
            x = layer_norm(self.norm, torch.cat([x1, x2], dim=-1))
            x = linear(self.final_cat_proj, x, dt)
        x = self.final_expand(x)
        # the 1x1 conv has no compute dtype in the JAX module: fp32 (fp64
        # in the float64 reference)
        return conv_nhwc(self.final_conv, x)


class CrossVSSMClassifier(_TwoInput):
    """Dual-branch CrossMamba classifier: (x1, x2) NHWC [B, H, W, 3] ->
    logits [B, num_classes] (fp32).

    "stage3": two encoders (``layers1``, ``layers2``: VSSLayers), a
    CrossMamba fusion (no residual) after the third stage, each branch's
    ``downsample{b}`` and fourth stage, the branches summed.
    "stage3_merged": the fused branches summed, then one ``downsample``
    and one ``fused_layer``.  "all": a ``DownLayer`` per stage (fusion
    with a residual at every stage), then ``before_head_proj`` on the
    branches' concat.  Then the global pool in fp32 and the head.  The
    class default d_state is 16; the registry sets 128."""

    def __init__(self, num_classes: int,
                 depths: Sequence[int] = (2, 2, 4, 2),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 d_state: int = 16, ssd_headdim: int = 64,
                 cat_method: str = "stack",
                 fuse_mode: str = "stage3", drop_path_rate: float = 0.1,
                 scan_impl: str = "auto", dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if fuse_mode not in ("stage3", "stage3_merged", "all"):
            raise ValueError(f"unknown fuse_mode: {fuse_mode!r}")
        blk = self._setup(dims, d_state, ssd_headdim, scan_impl, dtype)
        self.fuse_mode, self.cat_method = fuse_mode, cat_method
        self.n_stages = nl = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        rates = lambda i: _stage_rates(dpr, depths, i)
        if fuse_mode == "all":
            self.layers = nn.ModuleList(
                DownLayer(dims[i], rates(i), cat_method,
                          downsample=i < nl - 1, **blk) for i in range(nl))
            self.before_head_proj = nn.Linear(2 * dims[-1], dims[-1])
        else:
            n = nl if fuse_mode == "stage3" else nl - 1
            for b in (1, 2):
                self.add_module(f"layers{b}", nn.ModuleList(
                    VSSLayer(dims[i], rates(i), core="ssd",
                             downsample=i < nl - 2, **blk)
                    for i in range(n)))
            self.cat_proj = _cat_proj(dims[-2], cat_method)
            self.fusion = CrossMamba(dims[-2], headdim=ssd_headdim,
                                     scan_impl=scan_impl, dtype=dtype)
            if fuse_mode == "stage3_merged":
                self.downsample = PatchMerging(dims[-2], dtype=dtype)
                self.fused_layer = VSSLayer(dims[-1], rates(nl - 1),
                                            core="ssd", downsample=False,
                                            **blk)
            else:
                self.downsample1 = PatchMerging(dims[-2], dtype=dtype)
                self.downsample2 = PatchMerging(dims[-2], dtype=dtype)
        self.head = nn.Linear(dims[-1], num_classes)
        self.reset_parameters(generator)

    def forward(self, x1, x2):
        x1, x2 = self._embed(x1, x2)
        if self.fuse_mode == "all":
            for layer in self.layers:
                x1, x2, _ = layer(x1, x2)
            x = linear(self.before_head_proj, torch.cat([x1, x2], dim=-1),
                       self.dtype)
        else:
            # the stages before the fusion (stage3's layers also hold the
            # fourth stage, run after it)
            for i in range(self.n_stages - 1):
                x1, x2 = self.layers1[i](x1), self.layers2[i](x2)
            c1, c2 = cat_inputs(x1, x2, self.cat_method, self.cat_proj,
                                self.dtype)
            x1, x2 = self.fusion(x1, x2, c1, c2)
            if self.fuse_mode == "stage3_merged":
                x = self.fused_layer(self.downsample(x1 + x2))
            else:
                x = self.layers1[-1](self.downsample1(x1)) + \
                    self.layers2[-1](self.downsample2(x2))
        return linear(self.head, x.float().mean(dim=(1, 2)))
