"""The SS2D layers: four-direction 2-D scans (NHWC in and out).

Port of ``medical_image_classification_tpu/models/ss2d_modules.py``:
``SS2D`` (Mamba-1 core), ``SS2DSSD`` (Mamba-2 / SSD core, linear in_proj,
with the ST-SSD tail: ``STL``, ``STF`` and the WMF merge) and their init
helpers.  Both take ``model_axis`` (tensor parallelism: the name of the
current mesh's axis whose ranks split the layer's d_inner channels, or
heads, as ``parallel/sharding.py`` lays them out): the layer holds its
rank's parameters at local width, enters its region through
``reduce_grad`` (column-parallel in_proj) and leaves it through
``reduce_out`` (row-parallel out_proj); GSPMD's placement of the same
collectives in the JAX package.  Init follows the JAX modules:
Δ-projection weight U(-r^-0.5, r^-0.5), Δ-bias the softplus-inverse of a
log-uniform draw in [dt_min, dt_max] (one draw repeated over the K
directions), A = -exp(A_log) with S4D-real A_log (Mamba-1) or log U(1, 16)
per head (SSD, one draw repeated over K), D = 1.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.stf_zgate import (
    stf_zgate,
    stf_zgate_supported,
)
from medical_image_classification_tpu_torch.kernels.stl_mixer import (
    stl_mixer,
    stl_mixer_supported,
)
from medical_image_classification_tpu_torch.models.common import (
    batch_norm,
    conv_nhwc,
    layer_norm,
    lecun_normal_,
    linear,
)
from medical_image_classification_tpu_torch.models.kan_modules import (
    KANLinear,
)
from medical_image_classification_tpu_torch.ops.ss2d import (
    layer_norm_sharded,
    rmsnorm_gated,
    ss2d_core_mamba1,
    ss2d_core_ssd,
)
from medical_image_classification_tpu_torch.parallel.collectives import (
    gather_pieces,
    reduce_grad,
    reduce_out,
)
from medical_image_classification_tpu_torch.parallel.mesh import mesh_axis
from medical_image_classification_tpu_torch.parallel.sharding import (
    ssd_in_proj_split,
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


def _tp_ranks(model_axis, what: str, widths) -> int:
    """The size of the mesh axis ``model_axis`` (1 without one); raises
    ``ValueError`` where it does not divide each of ``widths``."""
    if model_axis is None:
        return 1
    tp = mesh_axis(model_axis).size
    for name, width in widths:
        if width % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks: the "
                             f"{what}'s {name} {width} does not divide by "
                             f"{tp}")
    return tp


def uniform_pm_(t, std, generator=None):
    return nn.init.uniform_(t, -std, std, generator=generator)


def torch_linear_rowmajor_(t, generator=None):
    """torch Linear's default init on a [K, out, in] stacked weight."""
    return uniform_pm_(t, 1.0 / math.sqrt(t.shape[-1]), generator)


class SS2D(nn.Module):
    """Mamba-1 four-direction 2-D selective scan layer (NHWC in/out).

    in_proj -> depthwise 3x3 conv -> SiLU -> scan core -> out_norm
    -> * silu(z) -> out_proj.  ``A_logs`` and ``Ds`` are stored flattened
    to [K * d_inner, ...], as in the reference ``state_dict``.
    ``seq_axis`` L-shards the scan over that axis of the current mesh
    (sequence parallelism, ``ops/ss2d.py``); ``model_axis`` splits d_inner
    over that axis (tensor parallelism: ``d_local`` channels a rank, and
    ``out_norm``'s statistics over all of them)."""

    def __init__(self, d_model: int, d_state: int = 16,
                 scan_impl: str = "auto", dtype=None, seq_axis=None,
                 model_axis=None):
        super().__init__()
        self.seq_axis, self.model_axis = seq_axis, model_axis
        self.d_inner = 2 * d_model                         # expand 2
        tp = _tp_ranks(model_axis, "SS2D", (("d_inner", self.d_inner),))
        self.d_local = D = self.d_inner // tp
        self.dt_rank = R = math.ceil(d_model / 16)
        self.d_state = N = d_state
        self.scan_impl = scan_impl
        self.dtype = dtype
        self.in_proj = nn.Linear(d_model, 2 * D, bias=False)
        self.conv2d = nn.Conv2d(D, D, 3, groups=D, padding=1)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, D))
        self.A_logs = nn.Parameter(torch.empty(K * D, N))
        self.Ds = nn.Parameter(torch.ones(K * D))
        self.out_norm = nn.LayerNorm(D, eps=1e-6)         # parity: Flax eps
        self.out_proj = nn.Linear(D, d_model, bias=False)

    def reset_scan_parameters(self, generator=None):
        torch_linear_rowmajor_(self.x_proj_weight, generator)
        uniform_pm_(self.dt_projs_weight, self.dt_rank ** -0.5, generator)
        dt_bias_init_(self.dt_projs_bias, generator)
        a_log_init_s4d_(self.A_logs)
        nn.init.ones_(self.Ds)

    def forward(self, x):
        tp = self.model_axis
        if tp is not None:
            x = reduce_grad(x, mesh_axis(tp))
        xz = linear(self.in_proj, x, self.dtype)
        xpart, z = xz.chunk(2, dim=-1)
        xpart = F.silu(conv_nhwc(self.conv2d, xpart, self.dtype))
        y = ss2d_core_mamba1(
            xpart, self.x_proj_weight, self.dt_projs_weight,
            self.dt_projs_bias, self.A_logs.view(K, self.d_local, -1),
            self.Ds.view(K, self.d_local), d_state=self.d_state,
            dt_rank=self.dt_rank, impl=self.scan_impl,
            seq_axis=self.seq_axis, model_axis=tp)
        # out_norm returns fp32; y * silu(z) stays fp32 until out_proj casts
        y = y.to(x.dtype)
        norm = self.out_norm
        y = layer_norm(norm, y) if tp is None else layer_norm_sharded(
            y, norm.weight, norm.bias, norm.eps, tp)
        y = linear(self.out_proj, y * F.silu(z), self.dtype)
        return y if tp is None else reduce_out(y, mesh_axis(tp))


class RMSNormGated(nn.Module):
    """The weight of ``rmsnorm_gated`` (state_dict key ``norm.weight``)."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


def _mix(conv1d: nn.Conv1d, a, b, dtype):
    """The reference's Conv1d(2 -> 1, k 1) over the pair (a, b) of [..., 1]
    statistics: the JAX module's Dense(2 -> 1) on their concatenation, in
    the compute dtype."""
    cd = dtype if dtype is not None else a.dtype
    return F.linear(torch.cat([a, b], dim=-1).to(cd),
                    conv1d.weight.view(1, 2).to(cd), conv1d.bias.to(cd))


class STL(nn.Module):
    """Semantic token learner: max+mean-pooled channel attention, then a
    softmax token mixer that makes p^2 semantic tokens from L positions,
    through the fused mixer (``kernels/stl_mixer.py``) where its gate
    says so.  y [B, L, C] -> U [B, p^2, C]."""

    def __init__(self, p: int, channels: int, impl: str = "auto",
                 dtype=None):
        super().__init__()
        self.p, self.impl, self.dtype = p, impl, dtype
        self.learnable_u1 = nn.Parameter(torch.empty(channels, p * p))
        self.learnable_u2 = nn.Parameter(torch.empty(channels, channels))
        self.conv1d = nn.Conv1d(2, 1, 1)

    def reset_parameters(self, generator=None):
        nn.init.uniform_(self.learnable_u1, 0.0, 1.0, generator=generator)
        nn.init.uniform_(self.learnable_u2, 0.0, 1.0, generator=generator)
        lecun_normal_(self.conv1d.weight, 2, generator)
        nn.init.zeros_(self.conv1d.bias)

    def forward(self, y):
        u1, u2 = self.learnable_u1, self.learnable_u2
        if self.dtype is not None:
            u1, u2, y = (t.to(self.dtype) for t in (u1, u2, y))
        m = _mix(self.conv1d, y.amax(-1, keepdim=True),
                 y.mean(-1, keepdim=True), self.dtype)
        w = torch.sigmoid(m) * y                           # [B, L, C]
        if stl_mixer_supported(w.shape[1], self.p ** 2, w.shape[-1]):
            return stl_mixer(w, u1.to(w.dtype), u2.to(w.dtype),
                             impl=self.impl)
        # the softmax in fp32 over the rows of the mixer in w's dtype
        A = torch.softmax((w @ u1.to(w.dtype)).float(), dim=-1).to(w.dtype)
        V = w @ u2.to(w.dtype)
        return torch.einsum("blp,blc->bpc", A, V)          # [B, p^2, C]


@functools.lru_cache(maxsize=None)
def _adaptive_bins(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """torch's AdaptiveAvgPool bins as a [n_in, n_out] matrix:
    out[i] = mean(x[floor(i n_in / n_out) : ceil((i + 1) n_in / n_out)]).
    Cached per device and dtype: a constant of the model, as in the JAX
    module, not a host-to-device copy on every forward.  Built outside
    inference mode, so that a matrix first made by an eval forward is still
    one that a later training step can save for its backward, and outside
    any FakeTensorMode (a FLOP count, ``utils/flops.py``), so that the cache
    holds values."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with torch.inference_mode(False), unset_fake_temporarily():
        M = torch.zeros(n_in, n_out)
        for i in range(n_out):
            a = (i * n_in) // n_out
            b = -(-((i + 1) * n_in) // n_out)
            M[a:b, i] = 1.0 / (b - a)
        return M.to(device, dtype)


class STF(nn.Module):
    """Semantic token fuser: a learned gate over pooled original features,
    applied to the tokens U, through the fused gate
    (``kernels/stf_zgate.py``) where its gate says so.

    The reference's pooling is transposed (it permutes a [B, C, L] input
    as if it were [B, L, C]), so its AdaptiveAvgPool2d((d_ssm, p^2)) maps
    the LENGTH axis to d_ssm "channels" and the CHANNEL axis to p^2
    "tokens"; trained checkpoints depend on it, and the JAX module keeps
    it, as static bin matrices.  So does this one."""

    def __init__(self, p: int, channels: int, impl: str = "auto",
                 dtype=None):
        super().__init__()
        self.p, self.channels = p, channels
        self.impl, self.dtype = impl, dtype
        self.learnable_z = nn.Parameter(torch.empty(channels, p * p))
        self.conv1d = nn.Conv1d(2, 1, 1)

    def reset_parameters(self, generator=None):
        nn.init.uniform_(self.learnable_z, 0.0, 1.0, generator=generator)
        lecun_normal_(self.conv1d.weight, 2, generator)
        nn.init.zeros_(self.conv1d.bias)

    def forward(self, z_feat, U, u_scale):
        """z_feat [B, L, Cin] (the block's d_model features), U [B, p^2,
        d_ssm].  STF is affine in U, so the caller passes the WMF-merged
        tokens and the sum of the merge weights as ``u_scale``:
        sum_k w_k STF(z, U_k) = u_scale * weighted + Z (sum_k w_k U_k)."""
        P = self.p ** 2
        B, L, Cin = z_feat.shape
        cd = self.dtype if self.dtype is not None else z_feat.dtype
        Mr = _adaptive_bins(L, self.channels, z_feat.device, cd)
        Mc = _adaptive_bins(Cin, P, z_feat.device, cd)
        lz, z_feat, U = (t.to(cd) for t in (self.learnable_z, z_feat, U))
        # [B, L, Cin] -> [B, channels, P]: L -> channels, Cin -> P
        pooled = torch.einsum("boc,cp->bop",
                              torch.einsum("blc,lo->boc", z_feat, Mr), Mc)
        pooled = F.silu(pooled)
        m = torch.sigmoid(_mix(self.conv1d,
                               pooled.amax(1).unsqueeze(-1),
                               pooled.mean(1).unsqueeze(-1), cd))  # [B,P,1]
        pooledT = pooled.transpose(1, 2)                   # [B, P, C]
        weighted = m * pooledT * u_scale.to(cd)
        if stf_zgate_supported(P, pooledT.shape[-1]):
            return weighted + stf_zgate(pooledT, lz, U, impl=self.impl)
        Z = torch.sigmoid(pooledT @ lz)                    # [B, P, P]
        return weighted + Z @ U


class SS2DSSD(nn.Module):
    """Mamba-2 (SSD) four-direction 2-D scan layer (NHWC in/out).

    in_proj -> [z | xBCdt] -> depthwise 3x3 conv + SiLU on xBCdt ->
    ``ss2d_core_ssd`` -> gated RMSNorm with z -> out_proj.  The JAX
    module's settings in every registry model: expand 2, one B/C group,
    all of d_inner scanned, RMSNorm on, conv bias only.  ``A_logs`` and
    ``Ds`` are stored flattened to [K * nheads] and ``dt_bias`` as
    [K, nheads], as in the reference ``state_dict``.  ``scan_impl`` drives
    the kernels of the layer ("auto", "cuda", "torch").

    ``st_tokens`` = p adds the ST-SSD tail: the core returns the four
    direction outputs (scan order), one ``STL`` over them (directions
    folded into the batch), the WMF merge (softmax of ``k_weights``)
    folded into one ``STF`` over the ``o_norm`` (BatchNorm) ->
    ``o_linear`` (1x1 conv) features of the layer's input.

    ``kan_filter`` puts an efficient-KAN d_model -> d_model in front of
    in_proj (kanoutSSD, ``filter_kan``); ``kan_in`` replaces in_proj by an
    efficient-KAN (kaninSSD, ``in_proj_kan``).  Both compute in fp32 and
    return their input's dtype (fp32 after the block's LayerNorm).  The
    JAX module's ``dropout`` is 0 in every model (no VSSLayer passes its
    blocks an ``attn_drop``), so the layer has none.  ``seq_axis``
    L-shards the scan over that axis of the current mesh (sequence
    parallelism, ``ops/ss2d.py``).  ``model_axis`` splits the heads over
    that axis (tensor parallelism): a rank holds ``h_local`` heads,
    ``d_local`` channels of z and x, and B and C whole (one group, every
    head reads them); ``in_proj_kan`` computes the whole projection and
    each rank keeps its blocks; the ST tail runs on all d_ssm channels,
    gathered over the axis, and each rank keeps its own of its output."""

    def __init__(self, d_model: int, d_state: int = 64, headdim: int = 64,
                 chunk_size: int = 256, st_tokens: int | None = None,
                 kan_in: bool = False, kan_filter: bool = False,
                 kan_spline_order: int = 1, scan_impl: str = "auto", dtype=None,
                 seq_axis=None, model_axis=None):
        super().__init__()
        self.seq_axis, self.model_axis = seq_axis, model_axis
        self.d_model = d_model
        self.d_ssm = d_ssm = 2 * d_model                   # expand 2
        self.headdim = headdim
        self.nheads = nheads = d_ssm // headdim
        self.d_state = d_state
        self.chunk_size = chunk_size
        self.st_tokens = st_tokens
        self.scan_impl = scan_impl
        self.dtype = dtype
        tp = _tp_ranks(model_axis, "SS2DSSD", (("heads", nheads),))
        d, h = d_ssm // tp, nheads // tp
        self.d_local, self.h_local = d, h
        conv_dim = d + 2 * d_state + h
        self.proj_split = ssd_in_proj_split(d_ssm, nheads, d_state, dim=-1)
        kan = lambda out: KANLinear(d_model, out,
                                    spline_order=kan_spline_order)
        self.filter_kan = kan(d_model) if kan_filter else None
        self.in_proj_kan = kan(2 * d_ssm + 2 * d_state + nheads) \
            if kan_in else None
        self.in_proj = None if kan_in else nn.Linear(
            d_model, d + conv_dim, bias=False)
        self.conv2d = nn.Conv2d(conv_dim, conv_dim, 3, groups=conv_dim,
                                padding=1)
        self.dt_bias = nn.Parameter(torch.empty(K, h))
        self.A_logs = nn.Parameter(torch.empty(K * h))
        self.Ds = nn.Parameter(torch.ones(K * h))
        self.norm = RMSNormGated(d)
        self.out_proj = nn.Linear(d, d_model, bias=False)
        if st_tokens is not None:
            self.stl = STL(st_tokens, d_ssm, scan_impl, dtype)
            self.stf = STF(st_tokens, d_ssm, scan_impl, dtype)
            self.o_norm = nn.BatchNorm2d(d_model, eps=1e-5, momentum=0.1)
            self.o_linear = nn.Conv2d(d_model, d_model, 1)
            self.k_weights = nn.Parameter(torch.full((K,), 0.25))

    def reset_scan_parameters(self, generator=None):
        a_log_init_uniform_(self.A_logs, generator)
        dt_bias_init_(self.dt_bias, generator)
        nn.init.ones_(self.Ds)
        nn.init.ones_(self.norm.weight)
        if self.st_tokens is not None:
            self.stl.reset_parameters(generator)
            self.stf.reset_parameters(generator)
            nn.init.constant_(self.k_weights, 0.25)

    def forward(self, u, update_stats: bool = True):
        """``update_stats``: whether a train-mode forward moves the running
        stats of ``o_norm`` (False in an activation-checkpoint recompute)."""
        if self.filter_kan is not None:
            u = self.filter_kan(u)
        tp = self.model_axis
        axis = None if tp is None else mesh_axis(tp)
        if axis is not None:
            u = reduce_grad(u, axis)
        if self.in_proj_kan is not None:
            zxbcdt = self.in_proj_kan(u)
            if axis is not None:
                zxbcdt = self.proj_split.piece(zxbcdt, axis.size, axis.index)
        else:
            zxbcdt = linear(self.in_proj, u, self.dtype)
        d, h = self.d_local, self.h_local
        z, xBCdt = zxbcdt.split([d, zxbcdt.shape[-1] - d], dim=-1)
        xBCdt = F.silu(conv_nhwc(self.conv2d, xBCdt, self.dtype))
        st = self.st_tokens is not None
        y = ss2d_core_ssd(
            xBCdt, self.A_logs.view(K, h), self.dt_bias, self.Ds.view(K, h),
            d_ssm=d, d_state=self.d_state, nheads=h, headdim=self.headdim,
            chunk_size=self.chunk_size, merge=not st, stack_scan_order=st,
            seq_axis=self.seq_axis, impl=self.scan_impl)
        if st:
            y = self._st_tail(u, y, update_stats, axis)
        # the core returns the compute dtype; the layer continues in u's
        # (fp32 after the block's LayerNorm) until out_proj casts
        y = rmsnorm_gated(y.to(u.dtype), z, self.norm.weight, model_axis=tp)
        y = linear(self.out_proj, y, self.dtype)
        return y if axis is None else reduce_out(y, axis)

    def _st_tail(self, u, ys, update_stats, axis=None):
        """ys [B, 4, L, d] (scan order) -> [B, H, W, d]: d = d_ssm, or under
        tensor parallelism (``axis``) this rank's d_local channels, the
        tail run on all d_ssm of them gathered over the axis (its gradient
        summed over the ranks' shares: ``gather_pieces``)."""
        Bb, H, W, _ = u.shape
        if axis is not None:
            ys = gather_pieces(ys, axis)             # [tp, B, 4, L, d]
            ys = ys.permute(1, 2, 3, 0, 4).flatten(3)
        L, p = H * W, self.st_tokens
        if p * p != L:
            raise ValueError(f"st_tokens^2 ({p * p}) must equal L ({L})")
        u_bn = batch_norm(self.o_norm, u.permute(0, 3, 1, 2), self.training,
                          update_stats).permute(0, 2, 3, 1)
        z_feat = conv_nhwc(self.o_linear, u_bn, self.dtype).reshape(Bb, L, -1)
        U4 = self.stl(ys.to(u.dtype).reshape(Bb * K, L, -1))
        U4 = U4.reshape(Bb, K, L, -1)
        w = torch.softmax(self.k_weights, dim=0)
        U_m = torch.einsum("k,bkpc->bpc", w.to(U4.dtype), U4)
        y = self.stf(z_feat, U_m, w.sum()).reshape(Bb, H, W, -1)
        if axis is None:
            return y
        d = self.d_local
        return y.narrow(-1, axis.index * d, d)
