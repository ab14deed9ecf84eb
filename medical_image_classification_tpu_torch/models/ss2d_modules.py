"""The SS2D layers: four-direction 2-D scans (NHWC in and out).

Port of ``medical_image_classification_tpu/models/ss2d_modules.py``:
``SS2D`` (Mamba-1 core), ``SS2DSSD`` (Mamba-2 / SSD core, linear in_proj)
and their init helpers.  Init follows the JAX modules: Δ-projection weight
U(-r^-0.5, r^-0.5), Δ-bias the softplus-inverse of a log-uniform draw in
[dt_min, dt_max] (one draw repeated over the K directions), A = -exp(A_log)
with S4D-real A_log (Mamba-1) or log U(1, 16) per head (SSD, one draw
repeated over K), D = 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_classification_tpu_torch.models.common import (
    conv_nhwc,
    layer_norm,
    linear,
)
from medical_image_classification_tpu_torch.ops.ss2d import (
    rmsnorm_gated,
    ss2d_core_mamba1,
    ss2d_core_ssd,
)

K = 4  # scan directions


def dt_bias_init_(t, generator=None, dt_min=0.001, dt_max=0.1, floor=1e-4):
    """Softplus-inverse of a log-uniform draw in [dt_min, dt_max] for
    ``t`` of shape [K, d]: one draw of d values, repeated across K."""
    with torch.no_grad():
        per = torch.rand(t.shape[1:], generator=generator)
        dt = torch.exp(per * (math.log(dt_max) - math.log(dt_min))
                       + math.log(dt_min)).clamp(min=floor)
        inv = dt + torch.log(-torch.expm1(-dt))
        return t.copy_(inv.expand(t.shape))


def a_log_init_s4d_(t):
    """S4D-real: A_log[..., n] = log(n + 1), the same for every channel."""
    with torch.no_grad():
        n = t.shape[-1]
        return t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                       .expand(t.shape))


def a_log_init_uniform_(t, generator=None, lo=1.0, hi=16.0):
    """SSD per-head init for ``t`` of shape [K * d] (or [K, d]): log of a
    U(lo, hi) draw of d values, repeated across the K directions."""
    with torch.no_grad():
        per = torch.rand(t.numel() // K, generator=generator) * (hi - lo) + lo
        return t.copy_(torch.log(per).repeat(K).reshape(t.shape))


def uniform_pm_(t, std, generator=None):
    return nn.init.uniform_(t, -std, std, generator=generator)


def torch_linear_rowmajor_(t, generator=None):
    """torch Linear's default init on a [K, out, in] stacked weight."""
    return uniform_pm_(t, 1.0 / math.sqrt(t.shape[-1]), generator)


class SS2D(nn.Module):
    """Mamba-1 four-direction 2-D selective scan layer (NHWC in/out).

    in_proj -> depthwise 3x3 conv -> SiLU -> scan core -> out_norm
    -> * silu(z) -> out_proj.  ``A_logs`` and ``Ds`` are stored flattened
    to [K * d_inner, ...], as in the reference ``state_dict``."""

    def __init__(self, d_model: int, d_state: int = 16,
                 scan_impl: str = "auto", dtype=None):
        super().__init__()
        self.d_inner = d_inner = 2 * d_model               # expand 2
        self.dt_rank = R = math.ceil(d_model / 16)
        self.d_state = N = d_state
        self.scan_impl = scan_impl
        self.dtype = dtype
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, 3, groups=d_inner,
                                padding=1)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, d_inner, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K * d_inner, N))
        self.Ds = nn.Parameter(torch.ones(K * d_inner))
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-6)   # parity: Flax eps
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def reset_scan_parameters(self, generator=None):
        torch_linear_rowmajor_(self.x_proj_weight, generator)
        uniform_pm_(self.dt_projs_weight, self.dt_rank ** -0.5, generator)
        dt_bias_init_(self.dt_projs_bias, generator)
        a_log_init_s4d_(self.A_logs)
        nn.init.ones_(self.Ds)

    def forward(self, x):
        xz = linear(self.in_proj, x, self.dtype)
        xpart, z = xz.chunk(2, dim=-1)
        xpart = F.silu(conv_nhwc(self.conv2d, xpart, self.dtype))
        y = ss2d_core_mamba1(
            xpart, self.x_proj_weight, self.dt_projs_weight,
            self.dt_projs_bias, self.A_logs.view(K, self.d_inner, -1),
            self.Ds.view(K, self.d_inner), d_state=self.d_state,
            dt_rank=self.dt_rank, impl=self.scan_impl)
        # out_norm returns fp32; y * silu(z) stays fp32 until out_proj casts
        y = layer_norm(self.out_norm, y.to(x.dtype))
        y = y * F.silu(z)
        return linear(self.out_proj, y, self.dtype)


class RMSNormGated(nn.Module):
    """The weight of ``rmsnorm_gated`` (state_dict key ``norm.weight``)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class SS2DSSD(nn.Module):
    """Mamba-2 (SSD) four-direction 2-D scan layer (NHWC in/out).

    in_proj -> [z | xBCdt] -> depthwise 3x3 conv + SiLU on xBCdt ->
    ``ss2d_core_ssd`` -> gated RMSNorm with z -> out_proj.  The JAX
    module's settings in every registry model: expand 2, one B/C group,
    all of d_inner scanned, RMSNorm on, conv bias only.  ``A_logs`` and
    ``Ds`` are stored flattened to [K * nheads] and ``dt_bias`` as
    [K, nheads], as in the reference ``state_dict``.  ``scan_impl`` drives
    the fused dirs SSD kernel ("auto", "cuda", "torch").  The KAN
    projections, the ST-SSD tail and dropout are not ported yet
    (ROADMAP.md Queue 1)."""

    def __init__(self, d_model: int, d_state: int = 64, headdim: int = 64,
                 chunk_size: int = 256, scan_impl: str = "auto", dtype=None):
        super().__init__()
        self.d_ssm = d_ssm = 2 * d_model                   # expand 2
        self.headdim = headdim
        self.nheads = nheads = d_ssm // headdim
        self.d_state = d_state
        self.chunk_size = chunk_size
        self.scan_impl = scan_impl
        self.dtype = dtype
        conv_dim = d_ssm + 2 * d_state + nheads
        self.in_proj = nn.Linear(d_model, d_ssm + conv_dim, bias=False)
        self.conv2d = nn.Conv2d(conv_dim, conv_dim, 3, groups=conv_dim,
                                padding=1)
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

    def forward(self, u):
        zxbcdt = linear(self.in_proj, u, self.dtype)
        z, xBCdt = zxbcdt.split([self.d_ssm, zxbcdt.shape[-1] - self.d_ssm],
                                dim=-1)
        xBCdt = F.silu(conv_nhwc(self.conv2d, xBCdt, self.dtype))
        y = ss2d_core_ssd(
            xBCdt, self.A_logs.view(K, self.nheads), self.dt_bias,
            self.Ds.view(K, self.nheads), d_ssm=self.d_ssm,
            d_state=self.d_state, nheads=self.nheads, headdim=self.headdim,
            chunk_size=self.chunk_size, impl=self.scan_impl)
        # the core returns the compute dtype; the layer continues in u's
        # (fp32 after the block's LayerNorm) until out_proj casts
        y = rmsnorm_gated(y.to(u.dtype), z, self.norm.weight)
        return linear(self.out_proj, y, self.dtype)
