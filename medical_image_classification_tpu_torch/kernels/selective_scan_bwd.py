"""Selective-scan backward in the folded layout: plain version, CUDA kernel
wrapper, and the ``torch.autograd.Function`` that joins the forward and
backward.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py
::_make_scan_folded`` (the custom VJP, for ``want_state=False`` and no
initial state) and of the backward kernel behind it
(``selective_scan_pallas_bwd_v2.py::bwd_folded_v2``).  Layout as in
``selective_scan_fwd.py``; xsave [G, ceil(L / CHUNK), N, Dm] fp32 is the
state entering each chunk, as the forward saved it.

Gradients: du and dΔ in u's dtype, dB and dC in B's dtype (each summed over
channels in fp32 and rounded once), dA [K, Dm, N], dD and dbias [K, Dm] in
fp32, summed over the batch from per-sequence partials.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    CHUNK,
    _check_cuda_args,
    _launch_cuda as _launch_fwd_cuda,
    scan_folded_fwd_ref,
)

_KERNEL = "selective_scan_bwd"
_LANES = 32          # channels per block of the kernel (dB/dC partials)


def _sum_partials(u, A, dA_part, dD_part, dbias_part):
    """Per-sequence parameter partials -> sums over the batch (sequence g
    belongs to parameter group g % K), as ``bwd_folded_v2:398-401``."""
    G, _, Dm = u.shape
    K, _, N = A.shape
    batch = G // K
    dA = dA_part.reshape(batch, K, N, Dm).sum(0).transpose(1, 2)
    dD = dD_part.reshape(batch, K, Dm).sum(0)
    dbias = dbias_part.reshape(batch, K, Dm).sum(0)
    return dA, dD, dbias


def scan_folded_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy,
                        reverse: bool = False, softplus: bool = True,
                        chunk: int = CHUNK):
    """Plain PyTorch version of the backward kernel: the same chunk walk,
    the same xsave, the same gradient formulas, vectorised over (G, Dm, N)
    and looping over t.  Returns (du, ddelta, dA, dB, dC, dD, dbias)."""
    f32 = torch.float32
    G, L, Dm = u.shape
    K, _, N = A.shape
    uf, dyf = u.to(f32), dy.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    Ag = A.to(f32).repeat(G // K, 1, 1)                    # [G, Dm, N]
    raw = delta.to(f32) + bias.to(f32).repeat(G // K, 1)[:, None, :]
    dt = F.softplus(raw) if softplus else raw              # [G, L, Dm]
    sig = torch.sigmoid(raw) if softplus else torch.ones_like(raw)
    dtu = dt * uf

    du = torch.empty(G, L, Dm, dtype=f32, device=u.device)
    ddelta = torch.empty_like(du)
    dB = torch.empty(G, L, N, dtype=f32, device=u.device)
    dC = torch.empty_like(dB)
    dA_part = torch.zeros(G, Dm, N, dtype=f32, device=u.device)
    carry = torch.zeros(G, Dm, N, dtype=f32, device=u.device)  # a_t g_t
    nT = -(-L // chunk)
    for ci in (range(nT) if reverse else range(nT - 1, -1, -1)):
        rows = range(ci * chunk, min((ci + 1) * chunk, L))
        scan_rows = rows[::-1] if reverse else rows
        # recompute the chunk's states from its incoming state
        x = xsave[:, ci].to(f32).transpose(1, 2)          # [G, Dm, N]
        xs = {}
        for t in scan_rows:
            x = torch.exp(dt[:, t, :, None] * Ag) * x + \
                dtu[:, t, :, None] * Bf[:, t, None, :]
            xs[t] = x
        # the adjoint, against the scan direction
        for t in reversed(scan_rows):
            g = Cf[:, t, None, :] * dyf[:, t, :, None] + carry
            xa = xs[t] - dtu[:, t, :, None] * Bf[:, t, None, :]  # a_t x_prev
            gB = (g * Bf[:, t, None, :]).sum(-1)            # [G, Dm]
            du[:, t] = dt[:, t] * gB + D.to(f32).repeat(G // K, 1) * dyf[:, t]
            ddelta[:, t] = sig[:, t] * ((g * xa * Ag).sum(-1)
                                        + uf[:, t] * gB)
            dB[:, t] = (g * dtu[:, t, :, None]).sum(1)
            dC[:, t] = (xs[t] * dyf[:, t, :, None]).sum(1)
            dA_part += g * xa * dt[:, t, :, None]
            carry = torch.exp(dt[:, t, :, None] * Ag) * g
    dA, dD, dbias = _sum_partials(u, A, dA_part.transpose(1, 2),
                                  (dyf * uf).sum(1), ddelta.sum(1))
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB.to(B.dtype),
            dC.to(C.dtype), dD, dbias)


def _check_bwd_args(u, delta, A, B, C, D, bias, xsave, dy):
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    N = A.shape[2]
    want = (G, -(-L // CHUNK), N, Dm)
    for name, t, shape, dtype in (("xsave", xsave, want, torch.float32),
                                  ("dy", dy, (G, L, Dm), u.dtype)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bwd_kernel(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part,
                dC_part, dA_part, dD_part, dbias_part, reverse, softplus):
    """Launch csrc/selective_scan_bwd.cu on the current stream; raises if
    the launch fails."""
    from medical_image_classification_tpu_torch.kernels import _build

    lib = _build.library(_KERNEL)
    fn = lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    G, L, Dm = u.shape
    K, _, N = A.shape
    ptrs = [t.data_ptr() for t in (u, delta, A, B, C, D, bias, xsave, dy, du,
                                   ddelta, dB_part, dC_part, dA_part, dD_part,
                                   dbias_part)]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(*ptrs, G, L, Dm, K, N, int(u.dtype == torch.bfloat16),
                int(reverse), int(softplus), stream)
    _build.raise_on_error(lib, _KERNEL, rc)


def _launch_cuda(u, delta, A, B, C, D, bias, xsave, dy, reverse, softplus):
    """The kernel wrapper: checks, allocates the outputs and the partials,
    launches, counts the launch, and sums the partials."""
    _check_bwd_args(u, delta, A, B, C, D, bias, xsave, dy)
    G, L, Dm = u.shape
    N = A.shape[2]
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dB_part = torch.empty(-(-Dm // _LANES), G, L, N, **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty(G, N, Dm, **f32)
    dD_part = torch.empty(G, Dm, **f32)
    dbias_part = torch.empty(G, Dm, **f32)
    _bwd_kernel(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part,
                dC_part, dA_part, dD_part, dbias_part, reverse, softplus)
    scan_folded_bwd.launches += 1
    dA, dD, dbias = _sum_partials(u, A, dA_part, dD_part, dbias_part)
    return (du, ddelta, dA, dB_part.sum(0).to(B.dtype),
            dC_part.sum(0).to(C.dtype), dD, dbias)


def scan_folded_bwd(u, delta, A, B, C, D, bias, xsave, dy,
                    reverse: bool = False, softplus: bool = True,
                    impl: str = "auto"):
    """Folded selective-scan backward: (du, ddelta, dA, dB, dC, dD, dbias).

    ``impl`` as in ``scan_folded_fwd``: the CUDA kernel for CUDA tensors
    ("auto"/"cuda", which raises rather than fall back) or the plain
    version ("torch", or "auto" on the CPU)."""
    if impl == "auto":
        impl = "cuda" if u.is_cuda else "torch"
    if impl == "torch":
        return scan_folded_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy,
                                   reverse=reverse, softplus=softplus)
    if impl != "cuda":
        raise ValueError(f"unknown scan impl: {impl!r} "
                         "(expected 'auto', 'cuda' or 'torch')")
    if not u.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; u is on {u.device}")
    return _launch_cuda(u, delta, A, B, C, D, bias, xsave, dy, reverse,
                        softplus)


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_folded_bwd.launches = 0


class ScanFolded(torch.autograd.Function):
    """The folded scan under autograd (``selective_scan_pallas.py:276-353``).

    The forward saves (u, delta, A, B, C, D, bias, xsave); the backward runs
    the backward kernel (``impl="cuda"``) or the plain backward
    (``impl="torch"``) and casts each gradient to its input's dtype, as
    ``_cast_like`` does.  A, D and bias arrive in fp32 (the dispatcher casts
    them)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, bias, reverse, softplus, impl):
        if impl == "cuda":
            y, xsave = _launch_fwd_cuda(u, delta, A, B, C, D, bias, reverse,
                                        softplus, want_xsave=True)
        else:
            y, xsave = scan_folded_fwd_ref(u, delta, A, B, C, D, bias,
                                           reverse=reverse, softplus=softplus,
                                           want_xsave=True)
        ctx.save_for_backward(u, delta, A, B, C, D, bias, xsave)
        ctx.flags = (reverse, softplus, impl)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors      # unpacked once (activation checkpoint)
        reverse, softplus, impl = ctx.flags
        # the cotangent of a column-layout direction arrives transposed
        # (ops/ss2d.py un_col); the kernel reads [G, L, Dm] rows
        run = _launch_cuda if impl == "cuda" else scan_folded_bwd_ref
        grads = run(*saved, dy.contiguous(), reverse, softplus)
        return tuple(g.to(p.dtype) for g, p in zip(grads, saved)) + (
            None, None, None)
