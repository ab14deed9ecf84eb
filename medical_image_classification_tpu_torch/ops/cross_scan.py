"""Four-direction 2-D cross-scan and cross-merge, time-major (NHWC).

Port of the time-major helpers of
``medical_image_classification_tpu/ops/cross_scan.py`` that the SSD core
uses, and ``cross_stack_scan_order`` (the ST-SSD stack).  Directions: 0
row-major, 1 column-major (the spatial transpose), 2 and 3 their sequence
flips.  The JAX module's ``split_channels`` (a custom VJP that assembles
the cotangent with one concatenate) is plain slicing here: autograd needs
no help with it.
"""

from __future__ import annotations

import torch


def _d0_d1(x):
    Bb, H, W, C = x.shape
    L = H * W
    return x.reshape(Bb, L, C), x.transpose(1, 2).reshape(Bb, L, C)


def cross_scan_time_major(x):
    """[B, H, W, C] -> [B, L, 4, C], the four directions on axis 2."""
    d0, d1 = _d0_d1(x)
    return torch.stack([d0, d1, d0.flip(1), d1.flip(1)], dim=2)


def cross_scan_time_major2_roles(x, d_ssm: int, gn: int):
    """The d0/d1 stack with role-major channels:
    [B, H, W, C'] -> [B, L, x_j0|x_j1|B_j0|B_j1|C_j0|C_j1|dt_j0|dt_j1].
    Directions 2/3 are never materialised: the fused dirs kernel reads
    them from these bytes through mirrored chunk indices."""
    d0, d1 = _d0_d1(x)
    o1, o2 = d_ssm, d_ssm + gn
    return torch.cat(
        [d0[..., :o1], d1[..., :o1],
         d0[..., o1:o2], d1[..., o1:o2],
         d0[..., o2:o2 + gn], d1[..., o2:o2 + gn],
         d0[..., o2 + gn:], d1[..., o2 + gn:]], dim=-1)


def _un_col(y, H, W):
    """Column-major [B, L, C] -> row-major [B, L, C]."""
    Bb, L, C = y.shape
    return y.reshape(Bb, W, H, C).transpose(1, 2).reshape(Bb, L, C)


def cross_merge_noflip_time_major(ys, H, W):
    """Merge for the fused dirs path: ys [B, L, 4, C] with directions 2/3
    already in d0/d1 order, so two adds and one un-transpose."""
    Bb, L, K, C = ys.shape
    assert K == 4 and L == H * W
    y02 = ys[:, :, 0] + ys[:, :, 2]
    y13 = _un_col(ys[:, :, 1] + ys[:, :, 3], H, W)
    return (y02 + y13).reshape(Bb, H, W, C)


def cross_merge_time_major(ys, H, W):
    """Inverse of ``cross_scan_time_major`` and the sum over directions:
    [B, L, 4, C] -> [B, H, W, C]."""
    Bb, L, K, C = ys.shape
    assert K == 4 and L == H * W
    y = (ys[:, :, 0] + _un_col(ys[:, :, 1], H, W) + ys[:, :, 2].flip(1)
         + _un_col(ys[:, :, 3].flip(1), H, W))
    return y.reshape(Bb, H, W, C)


def cross_stack_scan_order(ys):
    """[B, L, 4, C] -> [B, 4, L, C], each direction in its own scan order
    (no alignment flips or transposes).  Exact for consumers that do not
    depend on the order of L: the ST-SSD token mixer sums over L, and its
    gate, channel max/mean and row softmax are per position."""
    return ys.movedim(2, 1)
