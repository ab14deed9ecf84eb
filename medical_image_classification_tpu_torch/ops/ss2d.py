"""Functional SS2D core: the Mamba-1 four-direction 2-D selective scan.

Port of the flip-free branch of
``medical_image_classification_tpu/ops/ss2d.py::ss2d_core_mamba1``.  The
directions are k = rev * 2 + layout (0 = row, 1 = column, 2 = row reversed,
3 = column reversed).  Directions 2 and 3 scan in reverse over the same
unflipped bytes as directions 0 and 1, so no flipped copy is made.
"""

from __future__ import annotations

import torch

from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
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
