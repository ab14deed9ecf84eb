"""Selective-scan (Mamba-1) in PyTorch: the golden model, the chunked
plain scan, the dispatcher and the single-token decode step.

Port of ``medical_image_classification_tpu/kernels/selective_scan.py``:
the linear state-space recurrence

    x_t = exp(dt_t * A) * x_{t-1} + dt_t * B_t * u_t
    y_t = C_t . x_t  (+ D * u_t)  (* silu(z_t) if gated)

``selective_scan_seq`` walks it one timestep at a time;
``selective_scan_chunked`` (the JAX ``selective_scan_xla``) carries the
state across chunks of timesteps and runs a doubling scan inside each;
``selective_scan`` dispatches between them and the folded CUDA kernel
(``selective_scan_fwd.py::selective_scan_generic``);
``selective_state_update`` is one decode step.  The state and all
arithmetic are fp32.

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


def _prep(u, delta, A, B, C, delta_bias, delta_softplus):
    """fp32 operands (float64 stays float64: the exact reference), Δ with
    its bias and softplus, B/C with a group axis (``_prep_inputs``)."""
    wide = torch.promote_types(u.dtype, torch.float32)
    u, delta = u.to(wide), delta.to(wide)
    if delta_bias is not None:
        delta = delta + delta_bias.to(wide)
    if delta_softplus:
        # F.softplus's threshold branch returns x itself above 20, where
        # log1p(exp(x)) == x in fp32 anyway: the same values as
        # jax.nn.softplus
        delta = F.softplus(delta)
    if B.dim() == 3:
        B, C = B[:, :, None, :], C[:, :, None, :]
    return u, delta, A.to(wide), B.to(wide), C.to(wide)


def selective_scan_seq(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, return_last_state=False,
                       initial_state=None):
    """Sequential golden-model scan.  y has u's dtype; the state is fp32
    (float64 for float64 operands)."""
    out_dtype = u.dtype
    u, delta, A, B, C = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    wide = u.dtype
    batch, L, d = u.shape
    n = A.shape[1]
    rep = d // B.shape[2]

    x = (torch.zeros(batch, d, n, dtype=wide, device=u.device)
         if initial_state is None else initial_state.to(wide))
    ys = []
    for t in range(L):
        dt_t = delta[:, t]                                   # [batch, d]
        b_t = B[:, t].repeat_interleave(rep, dim=1)          # [batch, d, n]
        c_t = C[:, t].repeat_interleave(rep, dim=1)
        x = torch.exp(dt_t[..., None] * A) * x + (dt_t * u[:, t])[..., None] * b_t
        ys.append((x * c_t).sum(-1))
    y = torch.stack(ys, dim=1)                               # [batch, L, d]
    if D is not None:
        y = y + u * D.to(wide)
    if z is not None:
        y = y * F.silu(z.to(wide))
    y = y.to(out_dtype)
    if return_last_state:
        return y, x
    return y


def selective_scan_chunked(u, delta, A, B, C, D=None, z=None,
                           delta_bias=None, delta_softplus=False,
                           return_last_state=False, chunk: int = 128,
                           initial_state=None):
    """Chunked plain scan (port of ``selective_scan_xla``): a loop over
    chunks of ``chunk`` timesteps carries the [batch, d, N] state; inside a
    chunk a Hillis-Steele doubling scan over the time axis (the JAX
    ``associative_scan``) with the combine (a1, b1) o (a2, b2) = (a1 a2,
    a2 b1 + b2), then the incoming state is folded in.  The [batch, chunk,
    d, N] decay tensor of one chunk is the only large intermediate."""
    out_dtype = u.dtype
    u32, dt, A, Bm, Cm = _prep(u, delta, A, B, C, delta_bias,
                               delta_softplus)
    batch, L, d = u32.shape
    n = A.shape[1]
    rep = d // Bm.shape[2]
    x = (torch.zeros(batch, d, n, dtype=torch.float32, device=u.device)
         if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t0 in range(0, L, chunk):
        sl = slice(t0, min(t0 + chunk, L))
        dt_c = dt[:, sl]
        a = torch.exp(dt_c[..., None] * A)                    # [b, T, d, n]
        b = (dt_c * u32[:, sl])[..., None] * \
            Bm[:, sl].repeat_interleave(rep, dim=2)
        T, off = a.shape[1], 1
        while off < T:
            b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                          dim=1)
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
            off *= 2
        xs = b + a * x[:, None]
        ys.append((xs * Cm[:, sl].repeat_interleave(rep, dim=2)).sum(-1))
        x = xs[:, -1]
    y = torch.cat(ys, dim=1)
    if D is not None:
        y = y + u32 * D.to(torch.float32)
    if z is not None:
        y = y * F.silu(z.to(torch.float32))
    y = y.to(out_dtype)
    return (y, x) if return_last_state else y


def selective_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                   delta_softplus=False, return_last_state=False,
                   impl: str = "auto", chunk: int = 128):
    """Dispatching entry point (the JAX ``selective_scan``).

    ``impl``: "auto" takes the folded CUDA kernel for a CUDA tensor and its
    plain version for a CPU tensor; "cuda" (or the JAX name "pallas")
    launches the kernel or raises; "torch" runs the kernel's plain version
    through the same folded entry; "seq" the golden model; "chunked" the
    chunked plain scan.  Nothing falls back."""
    if impl == "pallas":
        impl = "cuda"
    if impl == "seq":
        return selective_scan_seq(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, return_last_state)
    if impl == "chunked":
        return selective_scan_chunked(u, delta, A, B, C, D, z, delta_bias,
                                      delta_softplus, return_last_state,
                                      chunk=chunk)
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown selective_scan impl: {impl!r} (expected "
                         "'auto', 'cuda', 'torch', 'seq' or 'chunked')")
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (  # noqa: E501
        selective_scan_generic)
    return selective_scan_generic(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, return_last_state,
                                  impl=impl)


def selective_state_update(state, x, dt, A, B, C, D=None, z=None,
                           dt_bias=None, dt_softplus=False):
    """One decode token (port of the JAX ``selective_state_update``, plain
    torch ops as it is plain XLA there).

    state [batch, d, n]; x, dt [batch, d]; A [d, n]; B, C [batch, n].
    Returns (new_state in state's dtype, y [batch, d] in x's dtype)."""
    f32 = torch.float32
    x32, dt32 = x.to(f32), dt.to(f32)
    if dt_bias is not None:
        dt32 = dt32 + dt_bias.to(f32)
    if dt_softplus:
        dt32 = F.softplus(dt32)
    dA = torch.exp(dt32[..., None] * A.to(f32))
    new_state = dA * state.to(f32) + (dt32 * x32)[..., None] * \
        B.to(f32)[:, None]
    y = torch.einsum("bdn,bn->bd", new_state, C.to(f32))
    if D is not None:
        y = y + D.to(f32) * x32
    if z is not None:
        y = y * F.silu(z.to(f32))
    return new_state.to(state.dtype), y.to(x.dtype)
