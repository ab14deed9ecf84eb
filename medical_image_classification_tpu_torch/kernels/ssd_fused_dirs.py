"""Four-direction fused SSD scan from the d0/d1 stack: plain versions of
the forward and the backward, the CUDA kernels' wrappers, the autograd
Function that joins them, and the dispatcher.

Port of ``medical_image_classification_tpu/kernels/ssd_fused_dirs_pallas.py``
(``ssd_fused_dirs`` and its custom VJP, ``_fwd_kernel``, ``_bwd_kernel``).
Kernels: ``csrc/ssd_fused_dirs_fwd.cu`` and ``csrc/ssd_fused_dirs_bwd.cu``
(the chunk walk of ``csrc/ssd_walk_{fwd,bwd}.cuh`` over the stack).

Layouts (one B/C group whose state couples the four directions, ref_flat;
H4 = 4 nh heads, direction-major; gn = d_state; N = 4 gn; C' = d_ssm + 2 gn
+ nh):
  stackr : [B, nc, l, 2 C']  role-major [x_j0|x_j1|B_j0|B_j1|C_j0|C_j1|dt_j0|
                             dt_j1]; head h reads x columns (h mod 2 nh) P
  acum   : [B, nc, H4, l]    fp32 inclusive cumsum of dt A, position order
  dte    : [B, nc, H4, l]    fp32 exp(acum[..., -1:] - acum)
  cdec   : [B, nc, H4]       fp32 exp(acum[..., -1])
  dtp    : [B, nc, H4, l]    fp32 softplus(dt + bias)
  Dsk    : [H4]              fp32 per-head D skip
  y      : [B, nc, l, H4 P]  in stackr's dtype, d0/d1 order
  Ssave  : [B, nc, H4, P, N] the state entering each chunk, stackr's dtype

Heads h >= H4 / 2 (directions 2 and 3) are the reverse class: their data
at chunk c is chunk nc - 1 - c of the d0/d1 bytes, reversed within the
chunk, and their y is written back there.  The coupled B/C rows of chunk c
are [l, 4 gn]: the direct [B_j0|B_j1] slab of chunk c, then the same slab
of chunk nc - 1 - c reversed.  Every product rounds its operands to the
stack's dtype where the TPU body does (``M``, ``dtx``, ``Sin``, ``dtx_d``)
and accumulates in fp32, so bf16 comparisons mean something.
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels import ops
from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    resolve_impl,
    via_op,
)
from medical_image_classification_tpu_torch.kernels.ssd_fused import (
    _DTYPES,
    BWD_TILE,
    MAX_L,
    MAX_N,
    PT,
    walk_bwd_ref,
    walk_fwd_ref,
)

_FWD_KERNEL = "ssd_fused_dirs_fwd"
_BWD_KERNEL = "ssd_fused_dirs_bwd"
# the walk kernels' shape limits (PT, MAX_L, MAX_N) are the single
# layout's: see kernels/ssd_fused.py


def _dims(stackr, acum, d_ssm):
    B, nc, l, C2c = stackr.shape
    H4 = acum.shape[2]
    nh = H4 // 4
    return B, nc, l, C2c, H4, nh, d_ssm // nh


def _mirror(t):
    """Chunk nc - 1 - c, reversed within the chunk (dims 1 and 2)."""
    return t.flip(1).flip(2)


def _operands(stackr, d_ssm, gn, H4):
    """Position-order x [B, nc, H4, l, P] and the coupled B/C rows
    [B, nc, l, 4 gn], fp32 (exact values of the stack's dtype)."""
    B, nc, l, _ = stackr.shape
    nh = H4 // 4
    P = d_ssm // nh
    xs = stackr[..., :2 * d_ssm].reshape(B, nc, l, 2 * nh, P)
    x4 = torch.cat([xs, _mirror(xs)], dim=3).transpose(2, 3).float()
    o = 2 * d_ssm
    Bd = stackr[..., o:o + 2 * gn]
    Cd = stackr[..., o + 2 * gn:o + 4 * gn]
    Bfull = torch.cat([Bd, _mirror(Bd)], dim=-1).float()
    Cfull = torch.cat([Cd, _mirror(Cd)], dim=-1).float()
    return x4, Bfull, Cfull


def _to_d01(yp):
    """Position-order [B, nc, H4, l, P] -> d0/d1 order [B, nc, l, H4 P]."""
    B, nc, H4, l, P = yp.shape
    h2 = H4 // 2
    y = torch.cat([yp[:, :, :h2], yp[:, :, h2:].flip(1).flip(3)], dim=2)
    return y.transpose(2, 3).reshape(B, nc, l, H4 * P)


def _from_d01(y, H4):
    """d0/d1 order [B, nc, l, H4 P] -> position order [B, nc, H4, l, P]."""
    B, nc, l, HP = y.shape
    yp = y.reshape(B, nc, l, H4, HP // H4).transpose(2, 3)
    h2 = H4 // 2
    return torch.cat([yp[:, :, :h2], yp[:, :, h2:].flip(1).flip(3)], dim=2)


def ssd_fused_dirs_fwd_ref(stackr, acum, dte, cdec, dtp, Dsk, d_ssm: int,
                           gn: int, want_save: bool = False):
    """Plain PyTorch version of the forward kernel: the TPU body's chunk
    walk (``kernels/ssd_fused.py::walk_fwd_ref``) over the position-order
    operands, with the D skip.  Returns y, and Ssave when ``want_save``."""
    H4 = acum.shape[2]
    x4, Bfull, Cfull = _operands(stackr, d_ssm, gn, H4)
    y, Ssave = walk_fwd_ref(x4, Bfull, Cfull, acum, dte, cdec, dtp,
                            stackr.dtype, Dsk, want_save)
    return (_to_d01(y), Ssave) if want_save else _to_d01(y)


def _cotangents(stackr, dx, dB2, dC2, dacum, ddte, dcdec, ddtp, dD, nh):
    """The kernels' outputs -> the cotangents of (stackr, acum, dte, cdec,
    dtp, Dsk), as ``_vjp_bwd``: the x cotangent is the sum of the two
    direction-class halves of dx, B/C slot in at their channel runs, the dt
    channels get zero (dt reaches the result through acum/dte/cdec/dtp)."""
    B, nc, l, _ = stackr.shape
    half = dx.shape[3] // 2
    dx2 = (dx[..., :half].float() + dx[..., half:].float()).to(stackr.dtype)
    d_stackr = torch.cat(
        [dx2, dB2, dC2, torch.zeros(B, nc, l, 2 * nh, dtype=stackr.dtype,
                                    device=stackr.device)], dim=-1)
    return d_stackr, dacum, ddte, dcdec, ddtp, dD.sum((0, 1))


def ssd_fused_dirs_bwd_ref(stackr, acum, dte, cdec, dtp, Dsk, d_ssm: int,
                           gn: int, Ssave, dy):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel`` and
    ``_vjp_bwd``): the reverse walk of ``kernels/ssd_fused.py::
    walk_bwd_ref`` over the position-order operands; the coupled B/C
    cotangents' flipped halves go back to the mirrored chunk, reversed.
    Returns the cotangents of (stackr, acum, dte, cdec, dtp, Dsk)."""
    H4 = acum.shape[2]
    gn2 = 2 * gn
    x4, Bfull, Cfull = _operands(stackr, d_ssm, gn, H4)
    dy4 = _from_d01(dy.to(stackr.dtype), H4).float()        # [B,nc,H4,l,P]
    dxp, dacum, ddte, dcdec, ddtp, dD, dB, dC = walk_bwd_ref(
        x4, Bfull, Cfull, acum, dte, cdec, dtp, Ssave, dy4, stackr.dtype, Dsk)
    dB2 = dB[..., :gn2] + _mirror(dB[..., gn2:])
    dC2 = dC[..., :gn2] + _mirror(dC[..., gn2:])
    return _cotangents(stackr, _to_d01(dxp), dB2, dC2, dacum, ddte, dcdec,
                       ddtp, dD, H4 // 4)


# --------------------------------------------------------------------------
# CUDA kernels


def _check_cuda_args(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn,
                     Ssave=None, dy=None):
    """The wrappers' argument checks, before any launch."""
    if stackr.dim() != 4:
        raise ValueError(f"stackr must be [B, nc, l, 2C'], got "
                         f"{tuple(stackr.shape)}")
    if stackr.dtype not in _DTYPES:
        raise TypeError(f"stackr must be float32 or bfloat16, got "
                        f"{stackr.dtype}")
    B, nc, l, C2c = stackr.shape
    if acum.dim() != 4:
        raise ValueError(f"acum must be [B, nc, H4, l], got "
                         f"{tuple(acum.shape)}")
    H4 = acum.shape[2]
    nh = H4 // 4
    if H4 % 4 or nh == 0 or d_ssm % nh:
        raise ValueError(f"H4={H4} heads do not split d_ssm={d_ssm}")
    P = d_ssm // nh
    N = 4 * gn
    if C2c != 2 * (d_ssm + 2 * gn + nh):
        raise ValueError(f"stackr has {C2c} channels, expected "
                         f"2 (d_ssm + 2 gn + nh) = "
                         f"{2 * (d_ssm + 2 * gn + nh)}")
    if P % PT or l > MAX_L or l % 4 or N > MAX_N or N % PT or nc < 1:
        raise ValueError(f"shape outside the kernels' limits: P={P} (a "
                         f"multiple of {PT}), l={l} (<= {MAX_L}, a multiple "
                         f"of 4), N={N} (<= {MAX_N}, a multiple of {PT})")
    want = [("acum", acum, (B, nc, H4, l), torch.float32),
            ("dte", dte, (B, nc, H4, l), torch.float32),
            ("cdec", cdec, (B, nc, H4), torch.float32),
            ("dtp", dtp, (B, nc, H4, l), torch.float32),
            ("Dsk", Dsk, (H4,), torch.float32)]
    if Ssave is not None:
        want.append(("Ssave", Ssave, (B, nc, H4, P, N), stackr.dtype))
    if dy is not None:
        want.append(("dy", dy, (B, nc, l, H4 * P), stackr.dtype))
    for name, t, shape, dtype in want:
        if t.device != stackr.device:
            raise ValueError(f"{name} is on {t.device}, stackr on "
                             f"{stackr.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not stackr.is_contiguous():
        raise ValueError("stackr must be contiguous")
    if B * nc > 65535:
        raise ValueError(f"B * nc = {B * nc} exceeds the grid limit 65535")


def _launch_fwd_cuda(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn,
                     want_save=False):
    """The forward kernel's wrapper: checks, allocates y, the entering
    states (Ssave; without ``want_save`` a workspace of its shape, which
    the output pass reads) and the workspaces, launches on the current
    stream, counts."""
    _check_cuda_args(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn)
    B, nc, l, C2c, H4, nh, P = _dims(stackr, acum, d_ssm)
    dev, mm = stackr.device, stackr.dtype
    y = torch.empty(B, nc, l, H4 * P, dtype=mm, device=dev)
    Ssave = torch.empty(B, nc, H4, P, 4 * gn, dtype=mm, device=dev)
    scores = torch.empty(B, nc, l, l, dtype=torch.float32, device=dev)
    pre = torch.empty(2, B, nc, H4, l, P, dtype=mm, device=dev)  # dtx rows
    bc = torch.empty(2, B, nc, l, 4 * gn, dtype=mm, device=dev)  # B/C rows
    ptrs = [t.data_ptr() for t in (stackr, acum, dte, cdec, dtp, Dsk, y,
                                   Ssave, scores, pre, bc)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             ptrs + [B, nc, l, H4, P, d_ssm, gn, int(mm == torch.bfloat16),
                     stream])
    ssd_fused_dirs_fwd.launches += 1
    return (y, Ssave) if want_save else y


def _launch_bwd_cuda(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, Ssave,
                     dy):
    """The backward kernel's wrapper: checks, allocates the outputs, the
    workspaces and the per-block fp32 partials, launches, counts, and sums
    the partials (no atomics: the same bits on every run)."""
    _check_cuda_args(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, Ssave, dy)
    B, nc, l, C2c, H4, nh, P = _dims(stackr, acum, d_ssm)
    # the kernels copy 16-byte pieces
    stackr, acum, Ssave, dy = (dense(t) for t in (stackr, acum, Ssave, dy))
    dev, mm = stackr.device, stackr.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    nt, npt, nnt = (-(-n // BWD_TILE) for n in (l, P, 4 * gn))
    dx = torch.empty(B, nc, l, H4 * P, dtype=mm, device=dev)
    dso = torch.empty_like(Ssave)                 # rounded dS entering each
    scores = torch.empty(B, nc, l, l, **f32)      # chunk
    dsr = torch.empty(B, nc, l, l, dtype=mm, device=dev)
    pre = torch.empty(3, B, nc, H4, l, P, dtype=mm, device=dev)
    bc = torch.empty(2, B, nc, l, 4 * gn, dtype=mm, device=dev)  # B/C rows
    row_part = torch.empty(B, nc, H4, nt, l, **f32)
    col_part = torch.empty(B, nc, H4, nt, l, **f32)
    off_part = torch.empty(B, nc, H4, npt, l, **f32)
    ddte_part = torch.empty(B, nc, H4, npt, l, **f32)
    ddtp_part = torch.empty(B, nc, H4, npt, l, **f32)
    dD_part = torch.empty(B, nc, H4, nt * npt, **f32)
    dcdec_part = torch.empty(B, nc, H4, npt * nnt, **f32)
    dBC = torch.empty(4, B, nc, l, 2 * gn, dtype=mm, device=dev)
    ptrs = [t.data_ptr() for t in (
        stackr, acum, dte, cdec, dtp, Dsk, Ssave, dy, dx, dso, scores, dsr,
        pre, bc, row_part, col_part, off_part, ddte_part, ddtp_part, dD_part,
        dcdec_part, dBC)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs)
             + [ctypes.c_int] * 8 + [ctypes.c_void_p],
             ptrs + [B, nc, l, H4, P, d_ssm, gn, int(mm == torch.bfloat16),
                     stream])
    ssd_fused_dirs_bwd.launches += 1
    dacum = row_part.sum(3) - col_part.sum(3) + off_part.sum(3)
    dB_dir, dC_dir, dB_flip, dC_flip = dBC
    return _cotangents(stackr, dx, dB_dir + dB_flip, dC_dir + dC_flip, dacum,
                       ddte_part.sum(3), dcdec_part.sum(3),
                       ddtp_part.sum(3), dD_part.sum(3), nh)


# --------------------------------------------------------------------------
# dispatchers


def ssd_fused_dirs_fwd(stackr, acum, dte, cdec, dtp, Dsk, d_ssm: int,
                       gn: int, want_save: bool = False, impl: str = "auto"):
    """The forward: y, and Ssave when ``want_save``.  ``impl`` "auto" takes
    the CUDA kernel for a CUDA tensor and the plain version for a CPU
    tensor; "cuda" launches the kernel or raises; "torch" runs the plain
    version on any device."""
    impl = resolve_impl(impl, stackr, "SSD")
    if not via_op(impl, stackr):
        return ssd_fused_dirs_fwd_ref(stackr, acum, dte, cdec, dtp, Dsk,
                                      d_ssm, gn, want_save)
    outs = ops.ssd_fused_dirs_fwd(stackr, acum, dte, cdec, dtp, Dsk, d_ssm,
                                  gn, want_save, impl)
    return tuple(outs) if want_save else outs[0]


def op_forward(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, want_save,
               impl):
    """The body of ``ops.ssd_fused_dirs_fwd``: the kernel (``impl``
    "cuda") or the plain version ("torch"); [y, Ssave?]."""
    run = _launch_fwd_cuda if impl == "cuda" else ssd_fused_dirs_fwd_ref
    outs = run(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, want_save)
    return list(outs) if want_save else [outs]


def ssd_fused_dirs_bwd(stackr, acum, dte, cdec, dtp, Dsk, d_ssm: int,
                       gn: int, Ssave, dy, impl: str = "auto"):
    """The backward: the cotangents of (stackr, acum, dte, cdec, dtp, Dsk).
    ``impl`` as in ``ssd_fused_dirs_fwd``."""
    impl = resolve_impl(impl, stackr, "SSD")
    if not via_op(impl, stackr):
        return ssd_fused_dirs_bwd_ref(stackr, acum, dte, cdec, dtp, Dsk,
                                      d_ssm, gn, Ssave, dy)
    return tuple(ops.ssd_fused_dirs_bwd(stackr, acum, dte, cdec, dtp, Dsk,
                                        d_ssm, gn, Ssave, dy, impl))


def op_backward(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, Ssave, dy,
                impl):
    """The body of ``ops.ssd_fused_dirs_bwd``: the kernel (``impl``
    "cuda") or the plain version ("torch"); the cotangents in their
    primals' dtypes."""
    args = (stackr, acum, dte, cdec, dtp, Dsk)
    run = _launch_bwd_cuda if impl == "cuda" else ssd_fused_dirs_bwd_ref
    grads = run(*args, d_ssm, gn, Ssave, dy)
    return [g.to(p.dtype) for g, p in zip(grads, args)]


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
ssd_fused_dirs_fwd.launches = 0
ssd_fused_dirs_bwd.launches = 0


class SSDFusedDirs(torch.autograd.Function):
    """``ssd_fused_dirs`` under autograd (the JAX custom VJP): the forward
    saves Ssave, the backward runs the backward kernel or the plain
    backward by the same ``impl``."""

    @staticmethod
    def forward(ctx, stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, impl):
        y, Ssave = ssd_fused_dirs_fwd(stackr, acum, dte, cdec, dtp, Dsk,
                                      d_ssm, gn, want_save=True, impl=impl)
        ctx.save_for_backward(stackr, acum, dte, cdec, dtp, Dsk, Ssave)
        ctx.flags = (d_ssm, gn, impl)
        return y

    @staticmethod
    def backward(ctx, dy):
        stackr, acum, dte, cdec, dtp, Dsk, Ssave = ctx.saved_tensors
        d_ssm, gn, impl = ctx.flags
        grads = ssd_fused_dirs_bwd(stackr, acum, dte, cdec, dtp, Dsk, d_ssm,
                                   gn, Ssave, dy.to(stackr.dtype).contiguous(),
                                   impl=impl)
        return grads + (None, None, None)


def ssd_fused_dirs(stackr, acum, dte, cdec, dtp, Dsk, d_ssm: int, gn: int,
                   impl: str = "auto"):
    """Four-direction folded SSD from the d0/d1 stack (see the module
    docstring).  With grad enabled and an input that requires grad, the
    call goes through ``SSDFusedDirs``; otherwise only the forward runs,
    without saved states.  acum, dte, cdec, dtp and Dsk are taken to fp32
    here, as the JAX caller builds them."""
    impl = resolve_impl(impl, stackr, "SSD")
    acum, dte, cdec, dtp, Dsk = (t.float().contiguous()
                                 for t in (acum, dte, cdec, dtp, Dsk))
    stackr = stackr.contiguous()
    args = (stackr, acum, dte, cdec, dtp, Dsk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDFusedDirs.apply(*args, d_ssm, gn, impl)
    return ssd_fused_dirs_fwd(*args, d_ssm, gn, impl=impl)
