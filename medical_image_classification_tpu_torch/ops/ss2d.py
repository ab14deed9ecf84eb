"""Functional SS2D cores: the four-direction 2-D scans.

Port of ``medical_image_classification_tpu/ops/ss2d.py``:
``ss2d_core_mamba1`` (its flip-free branch), ``ss2d_core_ssd`` (ref_flat,
one group; merged, or the ST-SSD scan-order stack) and ``rmsnorm_gated``.
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


def ss2d_core_mamba1(x, x_proj_w, dt_proj_w, dt_proj_b, A_log, Ds, *,
                     d_state: int, dt_rank: int, impl: str = "auto"):
    """Mamba-1 4-direction 2-D scan.

    x         : [B, H, W, D]  (post depthwise-conv + SiLU, channel-last)
    x_proj_w  : [4, dt_rank + 2*d_state, D]   (shared Δ/B/C projection)
    dt_proj_w : [4, D, dt_rank]
    dt_proj_b : [4, D]
    A_log     : [4, D, d_state]
    Ds        : [4, D]
    impl      : scan implementation, see ``scan_folded_fwd``

    Returns [B, H, W, D] in x's dtype: the sum of the four direction
    outputs, un-permuted to row order.
    """
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
            (bc_layout != "ref_flat", f"bc_layout={bc_layout!r}"),
            (seq_axis is not None, f"seq_axis={seq_axis!r} (the SP scans)")):
        if unported:
            raise NotImplementedError(
                f"ss2d_core_ssd {what} is not ported yet (ROADMAP.md Queue "
                "1)")
    Bb, H, W, Cc = xBCdt.shape
    L = H * W
    K = 4
    gn = d_state
    A = -torch.exp(A_log.float()).reshape(K * nheads)
    Df = Ds.float().reshape(-1)
    dtb = dt_bias.float().reshape(K * nheads)

    eff_c = ssd_dirs_chunk(L, chunk_size, K * d_state, headdim, K * nheads,
                           d_ssm, card=xBCdt.is_cuda) if merge else None
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
    y = ssd_chunked(xh, dth, A, Bh, Ch, chunk_size, Df, dtb, impl=impl)
    ys = y.reshape(Bb, L, K, d_ssm)
    if merge:
        return cross_merge_time_major(ys, H, W)
    return cross_stack_scan_order(ys)


def rmsnorm_gated(x, z, weight, *, eps: float = 1e-5):
    """Gated RMSNorm in fp32, returned in x's dtype: rmsnorm(x * silu(z))
    over the last axis, times ``weight`` (the JAX function with the models'
    settings: the gate before the norm, one group)."""
    g = x.float() * F.silu(z.float())
    y = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)
