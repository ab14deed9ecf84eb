"""Functional SS2D cores: the four-direction 2-D scans.

Port of ``medical_image_classification_tpu/ops/ss2d.py``:
``ss2d_core_mamba1`` (its flip-free branch, and its sequence-parallel
branch), ``ss2d_core_ssd`` (ref_flat, one group; merged, or the ST-SSD
scan-order stack; L-sharded under sequence parallelism) and
``rmsnorm_gated``; and the pieces of tensor parallelism (``model_axis``:
a rank holds some of the d_inner channels, or of the heads): the Mamba-1
core's projections summed over the axis, ``rmsnorm_gated`` and
``layer_norm_sharded`` with their statistics summed over it.
The directions are k = rev * 2 + layout (0 = row, 1 = column, 2 = row
reversed, 3 = column reversed).  Directions 2 and 3 read the same
unflipped bytes as directions 0 and 1 wherever a kernel can: the Mamba-1
scan runs in reverse, the fused SSD kernel mirrors its chunk indices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
)
from medical_image_classification_tpu_torch.kernels.ssd import (
    ssd_chunked,
    ssd_chunked_dirs,
    ssd_dirs_chunk,
)
from medical_image_classification_tpu_torch.ops.cross_scan import (
    cross_merge_noflip_time_major,
    cross_merge_time_major,
    cross_scan_time_major,
    cross_scan_time_major2_roles,
    cross_stack_scan_order,
)
from medical_image_classification_tpu_torch.parallel.collectives import (
    all_reduce_sum,
)
from medical_image_classification_tpu_torch.parallel.mesh import mesh_axis
from medical_image_classification_tpu_torch.parallel.sequence_parallel import (
    check_divisible,
    scan_sequence_parallel,
    ssd_scan_sequence_parallel,
)


def _scan_seq_parallel_mamba1(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds,
                              d_state, dt_rank, seq_axis, impl, model=None):
    """The JAX SP path (``ops/ss2d.py:177-197``): the four directions
    materialised by ``cross_scan_time_major`` (2 and 3 flipped), so that
    every direction scans forward and an incoming state always comes from
    the shards before; the two-stage Δ projection; the directions folded
    into the scan's groups (G = batch x 4, A, D and the bias per
    direction); the scan L-sharded over the mesh axis ``seq_axis``.  With
    ``model`` (the 'model' Axis), x holds this rank's channels and the
    projection's partial sums are summed over it."""
    Bb, H, W, D = x.shape
    L, K, N = H * W, 4, d_state
    axis = mesh_axis(seq_axis)
    check_divisible(L, axis)
    xs = cross_scan_time_major(x).transpose(1, 2)        # [B, 4, L, D]
    x_dbl = torch.einsum("bkld,kcd->bklc", xs, x_proj_w.to(x.dtype))
    if model is not None:
        x_dbl = all_reduce_sum(x_dbl, model)
    dts = torch.einsum("bklr,kdr->bkld", x_dbl[..., :dt_rank],
                       dt_proj_w.to(x.dtype))
    fold = lambda t: t.reshape(Bb * K, L, t.shape[-1]).contiguous()
    y = scan_sequence_parallel(
        fold(xs), fold(dts), -torch.exp(A_log.float()),
        fold(x_dbl[..., dt_rank:dt_rank + N]), fold(x_dbl[..., dt_rank + N:]),
        Ds.float(), dt_proj_b.float(), axis, impl=impl)
    return cross_merge_time_major(y.reshape(Bb, K, L, D).transpose(1, 2),
                                  H, W)


def _core_mamba1_tp(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds, d_state,
                    dt_rank, model, impl):
    """The flip-free core on this rank's channels of x (the 'model' Axis
    ``model``): the projection x -> [Δ-rank | B | C] of each direction is
    a sum over all d_inner channels, so each rank's partial product
    (all four directions at once) is summed over the axis, and Δ takes the
    two-stage form, x_dbl's rank columns through this rank's rows of the
    Δ projection (the fold into one [D, D] weight needs every channel)."""
    Bb, H, W, D = x.shape
    L, N, R = H * W, d_state, dt_rank
    x_row = x.reshape(Bb, L, D).contiguous()
    x_col = x.transpose(1, 2).reshape(Bb, L, D).contiguous()
    Wp = x_proj_w.reshape(2, 2, -1, D).to(x.dtype)       # [r, j, R + 2N, D]
    # [B, L, j, r, R + 2N]: every direction's partial x_dbl, summed once
    x_dbl = all_reduce_sum(torch.stack([
        torch.einsum("bld,rcd->blrc", xj, Wp[:, j])
        for j, xj in enumerate((x_row, x_col))], dim=2), model)
    dtw = dt_proj_w.reshape(2, 2, D, R).to(x.dtype)      # [r, j, e, q]
    A2 = -torch.exp(A_log.float()).reshape(2, 2, D, N)
    D2 = Ds.float().reshape(2, 2, D)
    b2 = dt_proj_b.float().reshape(2, 2, D)
    ys = {}
    for j, xj in enumerate((x_row, x_col)):
        for r in range(2):
            xd = x_dbl[:, :, j, r]
            ys[r, j] = scan_folded_fwd(
                xj, (xd[..., :R] @ dtw[r, j].T).contiguous(),
                A2[r, j][None], xd[..., R:R + N].contiguous(),
                xd[..., R + N:].contiguous(), D2[r, j][None],
                b2[r, j][None], reverse=bool(r), impl=impl)
    y_col = (ys[0, 1] + ys[1, 1]).reshape(Bb, W, H, D).transpose(1, 2)
    return (ys[0, 0] + ys[1, 0]).reshape(Bb, H, W, D) + y_col


def ss2d_core_mamba1(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds, *,
                     d_state: int, dt_rank: int, impl: str = "auto",
                     seq_axis=None, model_axis=None):
    """Mamba-1 4-direction 2-D scan.

    x         : [B, H, W, D]  (post depthwise-conv + SiLU, channel-last)
    x_proj_w  : [4, dt_rank + 2*d_state, D]   (shared Δ/B/C projection)
    dt_proj_w : [4, D, dt_rank]
    dt_proj_b : [4, D]
    A_log     : [4, D, d_state]
    Ds        : [4, D]
    impl      : scan implementation, see ``scan_folded_fwd``
    seq_axis  : None, or the name of the current mesh's axis over which
                the scan is L-sharded (sequence parallelism: the JAX
                package's path, ``_scan_seq_parallel_mamba1``; L must
                divide by the axis size, else ``ValueError``)
    model_axis: None, or the name of the current mesh's axis over which
                the channels are split (tensor parallelism): x and the
                per-channel parameters hold this rank's D channels of
                d_inner, ``x_proj_w`` its columns, and the projection's
                partial sums are summed over the axis

    Returns [B, H, W, D] in x's dtype: the sum of the four direction
    outputs, un-permuted to row order.
    """
    model = None if model_axis is None else mesh_axis(model_axis)
    if seq_axis is not None:
        return _scan_seq_parallel_mamba1(x, x_proj_w, dt_proj_w, dt_proj_b,
                                         A_log, Ds, d_state, dt_rank,
                                         seq_axis, impl, model)
    if model is not None:
        return _core_mamba1_tp(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds,
                               d_state, dt_rank, model, impl)
    Bb, H, W, D = x.shape
    L = H * W
    N = d_state
    x_row = x.reshape(Bb, L, D).contiguous()
    x_col = x.transpose(1, 2).reshape(Bb, L, D).contiguous()

    # One [D, 2D + 4N] projection per layout j.  The low-rank Δ projection
    # (D -> dt_rank -> D) folds into one effective [D, D] weight Weff; this
    # regroups the sums, so it agrees with the two-stage form to ~1e-3.
    Wp = x_proj_w.reshape(2, 2, -1, D)               # [r, j, q + 2N, D]
    Wq = Wp[:, :, :dt_rank]
    Wb = Wp[:, :, dt_rank:dt_rank + N]
    Wc = Wp[:, :, dt_rank + N:]
    dtw = dt_proj_w.reshape(2, 2, D, dt_rank)        # [r, j, e, q]
    Weff = torch.einsum("rjqd,rjeq->rjde", Wq, dtw)  # [r, j, D, D] fp32

    def proj(xj, j):
        # column order: [Δ_r0 | Δ_r1 | B_r0 | C_r0 | B_r1 | C_r1]
        Wall = torch.cat([Weff[0, j], Weff[1, j], Wb[0, j].T, Wc[0, j].T,
                          Wb[1, j].T, Wc[1, j].T], dim=1)
        out = xj @ Wall.to(x.dtype)                  # [B, L, 2D + 4N]
        # the kernel takes contiguous operands: copy the column slices out
        parts = torch.split(out, [D, D, N, N, N, N], dim=-1)
        return [p.contiguous() for p in parts]

    A2 = -torch.exp(A_log.float()).reshape(2, 2, D, N)
    D2 = Ds.float().reshape(2, 2, D)
    b2 = dt_proj_b.float().reshape(2, 2, D)

    def scan_dir(xj, dts, Bm, Cm, r, j):
        return scan_folded_fwd(xj, dts, A2[r, j][None], Bm, Cm,
                               D2[r, j][None], b2[r, j][None],
                               reverse=bool(r), impl=impl)

    dt0_row, dt1_row, B0_row, C0_row, B1_row, C1_row = proj(x_row, 0)
    dt0_col, dt1_col, B0_col, C0_col, B1_col, C1_col = proj(x_col, 1)
    y00 = scan_dir(x_row, dt0_row, B0_row, C0_row, 0, 0)   # dir 0
    y01 = scan_dir(x_col, dt0_col, B0_col, C0_col, 0, 1)   # dir 1
    y10 = scan_dir(x_row, dt1_row, B1_row, C1_row, 1, 0)   # dir 2 (rev)
    y11 = scan_dir(x_col, dt1_col, B1_col, C1_col, 1, 1)   # dir 3 (rev)

    def un_col(yc):                                  # [B, L, D] col -> row
        return yc.reshape(Bb, W, H, D).transpose(1, 2).reshape(Bb, L, D)

    y = y00 + y10 + un_col(y01 + y11)
    return y.reshape(Bb, H, W, D)


def ss2d_core_ssd(xBCdt, A_log, dt_bias, Ds, *, d_ssm: int, d_state: int,
                  nheads: int, headdim: int, chunk_size: int = 256,
                  merge: bool = True, stack_scan_order: bool = False,
                  bc_layout: str = "ref_flat", seq_axis=None,
                  impl: str = "auto"):
    """Mamba-2 (SSD) four-direction 2-D scan.

    xBCdt  : [B, H, W, d_ssm + 2 d_state + nheads] (post depthwise conv +
             SiLU; channels [x | B | C | dt], one B/C group)
    A_log, dt_bias, Ds : [4, nheads]
    impl   : the kernels' implementation ("auto", "cuda", "torch"; the
             fused dirs SSD, or the Y_diag of ``ssd_chunked``)
    seq_axis : None, or the current mesh's axis over which the scan is
             L-sharded: the four-direction stack goes through
             ``parallel/sequence_parallel.py::ssd_sequence_parallel`` (the
             fused dirs path is off, as in the JAX package; L must divide
             by the axis size, else ``ValueError``)

    The directions fold into the head axis (direction-major).  B and C are
    one group whose state is K d_state wide and shared by every head
    (ref_flat: the reference's flattening couples the directions through
    the state).  With ``merge``, where ``ssd_dirs_chunk`` finds a pad-free
    chunk in the window (and, for a CUDA tensor, a shape the CUDA kernels
    take), only the d0/d1 stack is built and the fused dirs kernel reads
    directions 2/3 from it; otherwise the four-direction stack goes through
    ``ssd_chunked``.  Returns [B, H, W, d_ssm] in xBCdt's dtype, or with
    ``merge=False`` and ``stack_scan_order`` the per-direction outputs
    [B, 4, L, d_ssm], each in its own scan order (the ST-SSD tail).
    """
    for unported, what in (
            (not (merge or stack_scan_order),
             "merge=False without stack_scan_order (the aligned stack)"),
            (bc_layout != "ref_flat", f"bc_layout={bc_layout!r}")):
        if unported:
            raise NotImplementedError(
                f"ss2d_core_ssd {what} is not ported yet (ROADMAP.md Queue "
                "1)")
    Bb, H, W, Cc = xBCdt.shape
    L = H * W
    K = 4
    gn = d_state
    axis = None
    if seq_axis is not None:
        axis = mesh_axis(seq_axis)
        check_divisible(L, axis)
    wide = torch.promote_types(xBCdt.dtype, torch.float32)
    A = -torch.exp(A_log.to(wide)).reshape(K * nheads)
    Df = Ds.to(wide).reshape(-1)
    dtb = dt_bias.to(wide).reshape(K * nheads)

    # float64 (the exact reference) takes the einsums of ``ssd_chunked``
    eff_c = ssd_dirs_chunk(L, chunk_size, K * d_state, headdim, K * nheads,
                           d_ssm, card=xBCdt.is_cuda) \
        if merge and wide == torch.float32 and axis is None else None
    if eff_c is not None:
        stackr = cross_scan_time_major2_roles(xBCdt, d_ssm, gn)
        y = ssd_chunked_dirs(stackr, A, Df, dtb, eff_c, d_ssm=d_ssm, gn=gn,
                             nheads=nheads, headdim=headdim, impl=impl)
        return cross_merge_noflip_time_major(
            y.reshape(Bb, L, K, d_ssm), H, W)

    xs_all = cross_scan_time_major(xBCdt)                 # [B, L, 4, Cc]
    xh = xs_all[..., :d_ssm].reshape(Bb, L, K * nheads, headdim)
    Bh = xs_all[..., d_ssm:d_ssm + gn].reshape(Bb, L, 1, K * d_state)
    Ch = xs_all[..., d_ssm + gn:d_ssm + 2 * gn].reshape(Bb, L, 1,
                                                         K * d_state)
    dth = xs_all[..., d_ssm + 2 * gn:].reshape(Bb, L, K * nheads)
    if axis is None:
        y = ssd_chunked(xh, dth, A, Bh, Ch, chunk_size, Df, dtb, impl=impl)
    else:
        y = ssd_scan_sequence_parallel(xh, dth, A, Bh, Ch, chunk_size, Df,
                                       dtb, axis, impl=impl)
    ys = y.reshape(Bb, L, K, d_ssm)
    if merge:
        return cross_merge_time_major(ys, H, W)
    return cross_stack_scan_order(ys)


def rmsnorm_gated(x, z, weight, *, eps: float = 1e-5, model_axis=None):
    """Gated RMSNorm in fp32 (fp64 for fp64 x), returned in x's dtype:
    rmsnorm(x * silu(z)) over the last axis, times ``weight`` (the JAX
    function with the models' settings: the gate before the norm, one
    group).  With ``model_axis`` (tensor parallelism: x, z and ``weight``
    hold this rank's channels) the mean square is over every rank's
    channels: the sum of squares is summed over the axis."""
    wide = torch.promote_types(x.dtype, torch.float32)
    g = x.to(wide) * F.silu(z.to(wide))
    if model_axis is None:
        ms = g.square().mean(-1, keepdim=True)
    else:
        axis = mesh_axis(model_axis)
        ms = all_reduce_sum(g.square().sum(-1, keepdim=True), axis) / (
            g.shape[-1] * axis.size)
    y = g * torch.rsqrt(ms + eps)
    return (y * weight.to(wide)).to(x.dtype)


def layer_norm_sharded(x, weight, bias, eps: float, model_axis: str):
    """LayerNorm over the last axis of a tensor whose channels are split
    over the mesh axis ``model_axis`` (x, ``weight`` and ``bias`` hold this
    rank's): fp32 (fp64 stays), returned in fp32, as ``models/common.py::
    layer_norm``.  Two passes, as torch's: the mean from the sums over the
    axis, then the biased variance from the centred squares' sums."""
    axis = mesh_axis(model_axis)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[-1] * axis.size
    mean = all_reduce_sum(x.sum(-1, keepdim=True), axis) / n
    xc = x - mean
    var = all_reduce_sum(xc.square().sum(-1, keepdim=True), axis) / n
    return xc * torch.rsqrt(var + eps) * weight + bias
