"""The VSSM classifier skeleton, Mamba-1 (``core="mamba1"``) and SSD
(``core="ssd"``) cores.

Port of ``medical_image_classification_tpu/models/vssm.py``: [ConvTConvPW
pre-stem] -> PatchEmbed -> [MIFA] -> stages of SS-Conv blocks
with PatchMerging between them -> global average pool (fp32) ->
classifier head (linear or one of the KAN heads).  NHWC float input
[B, H, W, 3] -> logits [B, num_classes] (fp32).

``use_checkpoint`` wraps each SS-Conv block in
``torch.utils.checkpoint.checkpoint`` (the JAX package's ``nn.remat``): the
block's activations are recomputed in the backward.  Its DropPath mask is
drawn once, outside the checkpointed region, and handed to both runs, and
the recompute leaves the BatchNorm running stats alone, so a checkpointed
step gives the same numbers as an unchecked one.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from medical_image_classification_tpu_torch.models.common import (
    ConvBranch,
    ConvTConvPW,
    DropPath,
    ECALayer,
    MIFABlock,
    PatchEmbed,
    PatchMerging,
    SeededGenerators,
    kaiming_conv_,
    layer_norm,
    trunc_normal_02_,
)
from medical_image_classification_tpu_torch.models.kan_modules import (
    KANLinear,
    OKANLayer,
    classify,
    head_modules,
)
from medical_image_classification_tpu_torch.models.ss2d_modules import (
    SS2D,
    SS2DSSD,
)


def reset_parameters(root: nn.Module, generator=None):
    """The JAX package's init distributions over ``root``'s modules, drawn
    from ``generator``: Linear trunc-normal(0.02) with zero bias, conv
    kaiming-normal (fan_out) with zero bias, norms (1, 0), each scan
    layer's scan parameters (``reset_scan_parameters``: SS2D, SS2DSSD with
    the ST-SSD tail's, CrossMamba)."""
    for m in root.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_02_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            kaiming_conv_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d, nn.BatchNorm1d)):
            m.reset_parameters()
        elif hasattr(m, "reset_scan_parameters"):
            m.reset_scan_parameters(generator)
        elif isinstance(m, (ECALayer, KANLinear, OKANLayer)):
            m.reset_parameters(generator)


class SSConvBlock(nn.Module):
    """The MedMamba hybrid block: split the channels; the LEFT half goes
    through the conv branch and the RIGHT half through LN -> SS2D
    (-> DropPath); interleave the two halves channel by channel
    (channel_shuffle with 2 groups); add the residual."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 d_state: int = 16, core: str = "mamba1",
                 ssd_chunk_size: int = 256, ssd_headdim: int = 64,
                 st_tokens: int | None = None, kan_in: bool = False,
                 kan_filter: bool = False, kan_spline_order: int = 1,
                 scan_impl: str = "auto", dtype=None,
                 use_checkpoint: bool = False,
                 rng: SeededGenerators | None = None):
        super().__init__()
        half = hidden_dim // 2
        self.use_checkpoint = use_checkpoint
        self.ln_1 = nn.LayerNorm(half, eps=1e-6)          # parity: Flax eps
        if core == "mamba1":
            self.self_attention = SS2D(d_model=half, d_state=d_state,
                                       scan_impl=scan_impl, dtype=dtype)
        elif core == "ssd":
            self.self_attention = SS2DSSD(
                d_model=half, d_state=d_state, headdim=ssd_headdim,
                chunk_size=ssd_chunk_size, st_tokens=st_tokens,
                kan_in=kan_in, kan_filter=kan_filter,
                kan_spline_order=kan_spline_order, scan_impl=scan_impl,
                dtype=dtype)
        else:
            raise ValueError(f"unknown core: {core!r}")
        self.drop_path = DropPath(drop_path, rng=rng)
        self.conv33conv33conv11 = ConvBranch(half, dtype=dtype)

    def _block(self, x, mask, update_stats=True):
        left, right = x.chunk(2, dim=-1)
        sa, r = self.self_attention, layer_norm(self.ln_1, right)
        # the ST-SSD tail's BatchNorm moves its running stats once per step
        r = sa(r, update_stats) if isinstance(sa, SS2DSSD) else sa(r)
        r = self.drop_path.drop(r, mask)
        l = self.conv33conv33conv11(left, update_stats=update_stats)
        b, h, w, half = l.shape
        # channel_shuffle(cat([l, r]), 2) is the plain interleave
        out = torch.stack([l, r], dim=-1).reshape(b, h, w, 2 * half)
        return out + x

    def forward(self, x):
        mask = self.drop_path.mask(x)
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return self._block(x, mask)
        runs = []

        def body(x, mask):
            # the first call is the forward, any later one the recompute
            runs.append(None)
            return self._block(x, mask, update_stats=len(runs) == 1)

        return checkpoint(body, x, mask, use_reentrant=False)


class VSSLayer(nn.Module):
    """One stage: one SSConvBlock per drop-path rate, then an optional
    PatchMerging."""

    def __init__(self, dim: int, drop_paths: Sequence[float],
                 d_state: int = 16, core: str = "mamba1",
                 ssd_chunk_size: int = 256, ssd_headdim: int = 64,
                 st_tokens: int | None = None, kan_in: bool = False,
                 kan_filter: bool = False, kan_spline_order: int = 1,
                 downsample: bool = True, scan_impl: str = "auto",
                 dtype=None, use_checkpoint: bool = False,
                 rng: SeededGenerators | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SSConvBlock(dim, drop_path=dp, d_state=d_state, core=core,
                        ssd_chunk_size=ssd_chunk_size,
                        ssd_headdim=ssd_headdim, st_tokens=st_tokens,
                        kan_in=kan_in, kan_filter=kan_filter,
                        kan_spline_order=kan_spline_order,
                        scan_impl=scan_impl, dtype=dtype,
                        use_checkpoint=use_checkpoint, rng=rng)
            for dp in drop_paths)
        self.downsample = PatchMerging(dim, dtype=dtype) if downsample \
            else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class VSSM(nn.Module):
    """VSSM image classifier.  NHWC [B, H, W, 3] -> logits.

    ``core`` is "mamba1" (SS2D) or "ssd" (SS2DSSD, with ``ssd_chunk_size``,
    ``ssd_headdim`` and, for ST-SSD, ``st_tokens``: the p of each stage).
    ``dtype`` is the compute dtype (bf16 on the card); parameters stay
    fp32.  ``scan_impl`` picks the implementation of the core's kernels
    (the selective scan; the SSD kernels and ST-SSD's): "auto" (by the
    tensor's device), "cuda" or "torch".  ``generator`` seeds the
    init.  The model owns ``drop_path_rng``, the source of every
    DropPath mask; a trainer seeds it with ``seed_drop_path``.

    ``conv_stem`` puts CNN-Mamba's ConvTConvPW in front of the patch
    embed (fp32, before the cast to ``dtype``), ``use_mifa`` a MIFA block
    after it.  ``kan_in`` / ``kan_filter`` (with ``kan_spline_order``) put
    efficient-KANs into every SS2DSSD; ``head`` picks the classifier head
    (one of ``HEAD_KINDS``; the ekan head's spline order is
    ``kan_spline_order``), whose modules are the model's own children
    under the reference's names.  ``forward(x, update_grid=True)``
    re-grids the ekan and okan heads on the batch.  The JAX model's
    ``drop_rate`` and ``attn_drop_rate`` are 0 in every registry model and
    CLI, and are not ported."""

    def __init__(self, num_classes: int,
                 depths: Sequence[int] = (2, 2, 4, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: int = 16, core: str = "mamba1",
                 ssd_chunk_size: int = 256, ssd_headdim: int = 64,
                 st_tokens: Sequence[int] | None = None,
                 drop_path_rate: float = 0.1, conv_stem: bool = False,
                 use_mifa: bool = False, kan_in: bool = False,
                 kan_filter: bool = False, kan_spline_order: int = 1,
                 head: str = "linear", scan_impl: str = "auto", dtype=None,
                 use_checkpoint: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rng = SeededGenerators(0)
        # the reference's name for the stem
        self.conv_T_conv = ConvTConvPW() if conv_stem else None
        self.patch_embed = PatchEmbed(dims[0], dtype=dtype)
        self.mifa = MIFABlock(dims[0]) if use_mifa else None
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     d_state=d_state, core=core,
                     ssd_chunk_size=ssd_chunk_size, ssd_headdim=ssd_headdim,
                     st_tokens=st_tokens[i] if st_tokens else None,
                     kan_in=kan_in, kan_filter=kan_filter,
                     kan_spline_order=kan_spline_order,
                     downsample=i < len(depths) - 1,
                     scan_impl=scan_impl, dtype=dtype,
                     use_checkpoint=use_checkpoint, rng=self.drop_path_rng)
            for i in range(len(depths)))
        self.head_kind = head
        for name, mod in head_modules(dims[-1], num_classes, head,
                                      kan_spline_order).items():
            self.add_module(name, mod)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_parameters(self, generator)

    def seed_drop_path(self, seed: int):
        """Restart every DropPath mask stream from ``seed``."""
        self.drop_path_rng.manual_seed(seed)

    def stage_names(self):
        """The stages by the JAX package's module names, ``layers_0`` ..."""
        return [f"layers_{i}" for i in range(len(self.layers))]

    @contextlib.contextmanager
    def stage_outputs(self, names=None):
        """Within the block, each forward puts the output of each stage in
        ``names`` (default: all), after its blocks and before its
        PatchMerging (the JAX ``stage_out`` intermediate and the point of
        its ``stage_perturb``), into the dict it yields under the stage's
        name, as a tensor of the autograd graph that requires grad: with
        grad enabled, ``torch.autograd.grad`` differentiates with respect
        to it.  Hooks only: the forward, its launches and the state_dict
        are those of the model without them."""
        names = self.stage_names() if names is None else list(names)
        unknown = sorted(set(names) - set(self.stage_names()))
        if unknown:
            raise ValueError(f"unknown stages {unknown}; the model has "
                             f"{self.stage_names()}")
        acts, handles = {}, []

        def keep(name, t):
            if not t.requires_grad:     # nothing before it requires grad
                t.requires_grad_()
            acts[name] = t

        for name in names:
            layer = self.layers[int(name.split("_")[1])]
            if layer.downsample is not None:
                handles.append(layer.downsample.register_forward_pre_hook(
                    lambda m, args, name=name: keep(name, args[0])))
            else:
                handles.append(layer.register_forward_hook(
                    lambda m, args, out, name=name: keep(name, out)))
        try:
            yield acts
        finally:
            for h in handles:
                h.remove()

    def forward(self, x, update_grid: bool = False):
        if self.conv_T_conv is not None:
            x = self.conv_T_conv(x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.patch_embed(x)
        if self.mifa is not None:
            x = self.mifa(x)
        for layer in self.layers:
            x = layer(x)
        x = x.float().mean(dim=(1, 2))                 # global pool in fp32
        return classify(self, self.head_kind, x, update_grid)
