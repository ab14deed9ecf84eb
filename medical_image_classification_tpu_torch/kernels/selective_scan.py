"""Selective-scan (Mamba-1) golden model in PyTorch.

Port of ``medical_image_classification_tpu/kernels/selective_scan.py``
``selective_scan_seq``: the linear state-space recurrence

    x_t = exp(dt_t * A) * x_{t-1} + dt_t * B_t * u_t
    y_t = C_t . x_t  (+ D * u_t)  (* silu(z_t) if gated)

walked one timestep at a time, with the state and all arithmetic in fp32.

Shapes (channel-last, as in the JAX package)
------
u, delta : [B, L, D]
A        : [D, N]            (real, negative)
B, C     : [B, L, N] or [B, L, G, N]   (G groups broadcast over D//G channels)
D        : [D] or None
z        : [B, L, D] or None
delta_bias : [D] or None
initial_state : [B, D, N] or None
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_scan_seq(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False,
                       initial_state=None):
    """Sequential golden-model scan.  y has u's dtype; the state is fp32."""
    out_dtype = u.dtype
    f32 = torch.float32
    u = u.to(f32)
    delta = delta.to(f32)
    if delta_bias is not None:
        delta = delta + delta_bias.to(f32)
    if delta_softplus:
        # F.softplus's threshold branch returns x itself above 20, where
        # log1p(exp(x)) == x in fp32 anyway: the same values as
        # jax.nn.softplus
        delta = F.softplus(delta)
    A = A.to(f32)
    if B.dim() == 3:
        B = B[:, :, None, :]
        C = C[:, :, None, :]
    B = B.to(f32)
    C = C.to(f32)
    batch, L, d = u.shape
    n = A.shape[1]
    rep = d // B.shape[2]

    x = (torch.zeros(batch, d, n, dtype=f32, device=u.device)
         if initial_state is None else initial_state.to(f32))
    ys = []
    for t in range(L):
        dt_t = delta[:, t]                                   # [batch, d]
        b_t = B[:, t].repeat_interleave(rep, dim=1)          # [batch, d, n]
        c_t = C[:, t].repeat_interleave(rep, dim=1)
        x = torch.exp(dt_t[..., None] * A) * x + (dt_t * u[:, t])[..., None] * b_t
        ys.append((x * c_t).sum(-1))
    y = torch.stack(ys, dim=1)                               # [batch, L, d]
    if D is not None:
        y = y + u * D.to(f32)
    if z is not None:
        y = y * F.silu(z.to(f32))
    y = y.to(out_dtype)
    if return_last_state:
        return y, x
    return y
