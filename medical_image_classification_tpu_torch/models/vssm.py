"""The VSSM classifier skeleton, Mamba-1 core.

Port of ``medical_image_classification_tpu/models/vssm.py``: PatchEmbed
-> stages of SS-Conv blocks with PatchMerging between them -> global
average pool (fp32) -> linear head.  NHWC float input [B, H, W, 3] ->
logits [B, num_classes] (fp32).

``use_checkpoint`` wraps each SS-Conv block in
``torch.utils.checkpoint.checkpoint`` (the JAX package's ``nn.remat``): the
block's activations are recomputed in the backward.  Its DropPath mask is
drawn once, outside the checkpointed region, and handed to both runs, and
the recompute leaves the BatchNorm running stats alone, so a checkpointed
step gives the same numbers as an unchecked one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from medical_image_classification_tpu_torch.models.common import (
    ConvBranch,
    DropPath,
    PatchEmbed,
    PatchMerging,
    SeededGenerators,
    kaiming_conv_,
    layer_norm,
    trunc_normal_02_,
)
from medical_image_classification_tpu_torch.models.kan_modules import (
    ClassifierHead,
)
from medical_image_classification_tpu_torch.models.ss2d_modules import SS2D


class SSConvBlock(nn.Module):
    """The MedMamba hybrid block: split the channels; the LEFT half goes
    through the conv branch and the RIGHT half through LN -> SS2D
    (-> DropPath); interleave the two halves channel by channel
    (channel_shuffle with 2 groups); add the residual."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 d_state: int = 16, scan_impl: str = "auto", dtype=None,
                 use_checkpoint: bool = False,
                 rng: SeededGenerators | None = None):
        super().__init__()
        half = hidden_dim // 2
        self.use_checkpoint = use_checkpoint
        self.ln_1 = nn.LayerNorm(half, eps=1e-6)          # parity: Flax eps
        self.self_attention = SS2D(d_model=half, d_state=d_state,
                                   scan_impl=scan_impl, dtype=dtype)
        self.drop_path = DropPath(drop_path, rng=rng)
        self.conv33conv33conv11 = ConvBranch(half, dtype=dtype)

    def _block(self, x, mask, update_stats=True):
        left, right = x.chunk(2, dim=-1)
        r = self.drop_path.drop(
            self.self_attention(layer_norm(self.ln_1, right)), mask)
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
                 d_state: int = 16, downsample: bool = True,
                 scan_impl: str = "auto", dtype=None,
                 use_checkpoint: bool = False,
                 rng: SeededGenerators | None = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SSConvBlock(dim, drop_path=dp, d_state=d_state,
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
    """VSSM image classifier, Mamba-1 core.  NHWC [B, H, W, 3] -> logits.

    ``dtype`` is the compute dtype (bf16 on the card); parameters stay fp32.
    ``scan_impl`` picks the selective scan: "auto" (by the tensor's
    device), "cuda" or "torch".  ``generator`` seeds the init.  The model
    owns ``drop_path_rng``, the source of every DropPath mask; a trainer
    seeds it with ``seed_drop_path``."""

    def __init__(self, num_classes: int,
                 depths: Sequence[int] = (2, 2, 4, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: int = 16, core: str = "mamba1",
                 drop_path_rate: float = 0.1, head: str = "linear",
                 scan_impl: str = "auto", dtype=None,
                 use_checkpoint: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if core != "mamba1":
            raise NotImplementedError(
                f"core {core!r} is not ported yet (ROADMAP.md Queue 1, "
                "item 7: the SSD slice)")
        self.dtype = dtype
        self.drop_path_rng = SeededGenerators(0)
        self.patch_embed = PatchEmbed(dims[0], dtype=dtype)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     d_state=d_state, downsample=i < len(depths) - 1,
                     scan_impl=scan_impl, dtype=dtype,
                     use_checkpoint=use_checkpoint, rng=self.drop_path_rng)
            for i in range(len(depths)))
        self.head = ClassifierHead(dims[-1], num_classes, kind=head)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """The JAX package's init distributions, drawn from ``generator``:
        Linear trunc-normal(0.02) with zero bias, conv kaiming-normal
        (fan_out), norms (1, 0), SS2D's scan parameters."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_02_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                kaiming_conv_(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
            elif isinstance(m, SS2D):
                m.reset_scan_parameters(generator)

    def seed_drop_path(self, seed: int):
        """Restart every DropPath mask stream from ``seed``."""
        self.drop_path_rng.manual_seed(seed)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        x = x.float().mean(dim=(1, 2))                 # global pool in fp32
        return self.head(x)
