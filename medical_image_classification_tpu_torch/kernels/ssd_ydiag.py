"""The SSD intra-chunk output Y_diag: the gate, the plain forward and
backward, the CUDA kernels' wrappers and dispatchers, and the autograd
Function that joins them.

Port of ``medical_image_classification_tpu/kernels/ssd_ydiag_pallas.py``
(``ydiag_supported``, the forward body ``_fwd_kernel``, the backward body
``_bwd_kernel`` and the custom VJP ``ydiag_fused``).  Kernels:
``csrc/ssd_ydiag_fwd.cu`` and ``csrc/ssd_ydiag_bwd.cu``.

Layouts (one B/C group, ref_flat; BC = batch x chunks):
  Cc, Bc : [BC, l, N]     the operand dtype (fp32 or bf16)
  acum   : [BC, H, l]     fp32 inclusive cumsum of dt A within the chunk
  dtx    : [BC, H, l, P]  head-major dt-weighted x
  y      : [BC, H, l, P]  in dtx's dtype

  y[bc, h, i] = sum_{j <= i} M[i, j] dtx[bc, h, j],
  M = rnd(scores[i, j] exp(a_i - a_j)),  scores = Cc[bc] Bc[bc]^T
with the scores summed in fp32 over operand-type values, rnd() rounding
to the operand dtype as the TPU body's ``.astype(mm_dtype)`` does, and
the product summed in fp32.  This is not the einsum ``_y_diag`` of
``kernels/ssd.py``, which rounds the scores and the decay separately.

The backward, at the TPU body's rounding points (dy taken to dtx's dtype):
  ddtx[s]  = sum_{i >= s} rnd(M)[i, s] dy[i]           rounded to dtx's dtype
  dM       = dy dtx^T                                   fp32
  G        = dM * M,  dacum = rowsums(G) - colsums(G)   M and G unrounded fp32
  dscores  = rnd(sum over the H heads of dM * decay)    summed in fp32
  dC = dscores Bc,  dB = dscores^T Cc                   rounded to their dtypes
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    resolve_impl,
)

_FWD_KERNEL = "ssd_ydiag_fwd"
_BWD_KERNEL = "ssd_ydiag_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# The chunk window of the gate; module constants so that tests can widen
# it to small shapes, as the JAX package's tests patch its ``_MIN_L``.
_MIN_L = 224
_MAX_L = 256
# shape limits of the CUDA kernels: the forward sums the scores over N in
# slabs of 128 and the backward over 64-column chunks, so shared memory
# does not grow with N; MAX_N is the widest state the card's checks cover
# (MedSSD's N 512).  The backward keeps a head's [64, P] cotangent tile in
# one 64-wide accumulator and two [l, 64] fp32 strips (l <= _MAX_L) in
# shared memory
MAX_N = 512
MAX_P_BWD = 64


def ydiag_supported(l: int, N: int, P: int, G: int, card: bool = False,
                    BC: int = 1, dtype: torch.dtype = torch.float32) -> bool:
    """The shape terms of the JAX gate (``ssd_ydiag_pallas.py:127-128``),
    without its backend term and its VMEM fit (``_pick_hb``).  ``card``:
    the operands lie on the GPU, where the CUDA kernels also need what
    ``_check_cuda_args`` asks of the forward and the backward: N <=
    ``MAX_N``, P <= ``MAX_P_BWD``, l <= ``_MAX_L``, BC <= 65535 and a
    float32 or bfloat16 dtype; elsewhere the plain version takes any of
    these shapes."""
    if not (G == 1 and _MIN_L <= l <= _MAX_L and l % 8 == 0 and N % 64 == 0
            and P % 8 == 0):
        return False
    return not card or (N <= MAX_N and P <= MAX_P_BWD and BC <= 65535
                        and dtype in _DTYPES)


def ydiag_fused_ref(Cc, Bc, acum, dtx):
    """Plain PyTorch version of the kernel (see the module docstring)."""
    mm = Cc.dtype
    l = Cc.shape[1]
    scores = Cc.float() @ Bc.float().transpose(1, 2)         # [BC, l, l]
    causal = torch.ones(l, l, dtype=torch.bool, device=Cc.device).tril()
    seg = (acum[..., :, None] - acum[..., None, :]).masked_fill(~causal, 0.0)
    E = torch.where(causal, torch.exp(seg), 0.0)             # [BC, H, l, l]
    M = (scores[:, None] * E).to(mm).float()
    return (M @ dtx.to(mm).float()).to(dtx.dtype)


def ydiag_fused_bwd_ref(Cc, Bc, acum, dtx, dy):
    """Plain PyTorch version of the backward kernel: (dCc, dBc, dacum,
    ddtx), the cotangents of the forward's operands (see the module
    docstring)."""
    mm = Cc.dtype
    l = Cc.shape[1]
    C32, B32 = Cc.float(), Bc.float()
    scores = C32 @ B32.transpose(1, 2)                       # [BC, l, l]
    causal = torch.ones(l, l, dtype=torch.bool, device=Cc.device).tril()
    seg = (acum[..., :, None] - acum[..., None, :]).masked_fill(~causal, 0.0)
    E = torch.where(causal, torch.exp(seg), 0.0)             # [BC, H, l, l]
    M = scores[:, None] * E
    dy32 = dy.to(mm).float()
    ddtx = (M.to(mm).float().transpose(2, 3) @ dy32).to(dtx.dtype)
    dM = dy32 @ dtx.to(mm).float().transpose(2, 3)
    G = dM * M
    dacum = G.sum(-1) - G.sum(-2)
    ds = (dM * E).sum(1).to(mm).float()                      # [BC, l, l]
    dC = (ds @ B32).to(Cc.dtype)
    dB = (ds.transpose(1, 2) @ C32).to(Bc.dtype)
    return dC, dB, dacum, ddtx


def _check_cuda_args(Cc, Bc, acum, dtx, dy=None):
    """Raise on operands the kernels do not take; ``dy`` (the backward's
    cotangent) also limits P to ``MAX_P_BWD`` and l to ``_MAX_L``."""
    if Cc.dim() != 3 or dtx.dim() != 4:
        raise ValueError(f"Cc must be [BC, l, N] and dtx [BC, H, l, P], got "
                         f"{tuple(Cc.shape)} and {tuple(dtx.shape)}")
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    if Cc.dtype not in _DTYPES or dtx.dtype != Cc.dtype:
        raise TypeError(f"Cc and dtx must both be float32 or bfloat16, got "
                        f"{Cc.dtype} and {dtx.dtype}")
    if N > MAX_N or BC > 65535 or (dy is not None and (P > MAX_P_BWD
                                                         or l > _MAX_L)):
        raise ValueError(f"shape outside the kernel's limits: N={N} (<= "
                         f"{MAX_N}), BC={BC} (<= 65535), P={P} and l={l} "
                         f"(<= {MAX_P_BWD} and {_MAX_L} in the backward)")
    named = [("Bc", Bc, (BC, l, N), Cc.dtype),
             ("acum", acum, (BC, H, l), torch.float32),
             ("dtx", dtx, (BC, H, l, P), Cc.dtype)]
    if dy is not None:
        named.append(("dy", dy, (BC, H, l, P), Cc.dtype))
    for name, t, shape, dtype in named:
        if t.device != Cc.device:
            raise ValueError(f"{name} is on {t.device}, Cc on {Cc.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for name, t in [("Cc", Cc)] + [(n, t) for n, t, _, _ in named]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_fwd_cuda(Cc, Bc, acum, dtx):
    """The forward kernel's wrapper: checks, allocates y, launches on the
    current stream, counts the launch."""
    _check_cuda_args(Cc, Bc, acum, dtx)
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    y = torch.empty_like(dtx)
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_void_p],
             [Cc.data_ptr(), Bc.data_ptr(), acum.data_ptr(), dtx.data_ptr(),
              y.data_ptr(), BC, l, N, H, P, int(Cc.dtype == torch.bfloat16),
              stream])
    ydiag_fused_fwd.launches += 1
    return y


def _launch_bwd_cuda(Cc, Bc, acum, dtx, dy):
    """The backward kernel's wrapper: checks, allocates the cotangents, the
    fp32 dscores workspace [BC, l, l] and the per-column-tile row sums of G
    [BC, H, l / 64, l], launches, counts, and sums the row sums (no
    atomics: the same bits on every run)."""
    _check_cuda_args(Cc, Bc, acum, dtx, dy)
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    f32 = dict(dtype=torch.float32, device=Cc.device)
    ddtx = torch.empty_like(dtx)
    row_part = torch.zeros(BC, H, -(-l // 64), l, **f32)
    col_sums = torch.empty(BC, H, l, **f32)
    dscores = torch.empty(BC, l, l, **f32)
    dC, dB = torch.empty_like(Cc), torch.empty_like(Bc)
    ptrs = [t.data_ptr() for t in (Cc, Bc, acum, dtx, dy, ddtx, row_part,
                                   col_sums, dscores, dC, dB)]
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
             + [ctypes.c_void_p],
             ptrs + [BC, l, N, H, P, int(Cc.dtype == torch.bfloat16),
                     stream])
    ydiag_fused_bwd.launches += 1
    return dC, dB, row_part.sum(2) - col_sums, ddtx


def ydiag_fused_fwd(Cc, Bc, acum, dtx, impl: str = "auto"):
    """Y_diag [BC, H, l, P] (see the module docstring).  ``impl``: "auto",
    "cuda" or "torch" (``kernels/_dispatch.py``)."""
    if resolve_impl(impl, Cc, "Y_diag") == "torch":
        return ydiag_fused_ref(Cc, Bc, acum, dtx)
    return _launch_fwd_cuda(dense(Cc), dense(Bc), dense(acum.float()),
                            dense(dtx))


def ydiag_fused_bwd(Cc, Bc, acum, dtx, dy, impl: str = "auto"):
    """The backward: (dCc, dBc, dacum, ddtx).  ``impl`` as in
    ``ydiag_fused_fwd``."""
    if resolve_impl(impl, Cc, "Y_diag") == "torch":
        return ydiag_fused_bwd_ref(Cc, Bc, acum, dtx, dy)
    return _launch_bwd_cuda(dense(Cc), dense(Bc), dense(acum.float()),
                            dense(dtx), dense(dy))


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
ydiag_fused_fwd.launches = 0
ydiag_fused_bwd.launches = 0


class YDiagFused(torch.autograd.Function):
    """``ydiag_fused`` under autograd (the JAX custom VJP): the backward
    takes the cotangent to dtx's dtype and runs the backward kernel or the
    plain backward by the same ``impl``."""

    @staticmethod
    def forward(ctx, Cc, Bc, acum, dtx, impl):
        ctx.save_for_backward(Cc, Bc, acum, dtx)
        ctx.impl = impl
        return ydiag_fused_fwd(Cc, Bc, acum, dtx, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        Cc, Bc, acum, dtx = ctx.saved_tensors
        return ydiag_fused_bwd(Cc, Bc, acum, dtx, dy.to(dtx.dtype),
                               impl=ctx.impl) + (None,)


def ydiag_fused(Cc, Bc, acum, dtx, impl: str = "auto"):
    """Y_diag [BC, H, l, P] (see the module docstring).  With grad enabled
    and an operand that requires grad, the call goes through
    ``YDiagFused``; otherwise only the forward runs.  acum is taken to
    fp32 and every operand made dense here, inside the autograd graph."""
    impl = resolve_impl(impl, Cc, "Y_diag")
    args = (dense(Cc), dense(Bc), dense(acum.float()), dense(dtx))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return YDiagFused.apply(*args, impl)
    return ydiag_fused_fwd(*args, impl=impl)
