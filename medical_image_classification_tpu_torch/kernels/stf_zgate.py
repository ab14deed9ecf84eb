"""The ST-SSD fusion gate: the gate, the plain forward and backward, the
CUDA kernels' wrappers and dispatchers, and the autograd Function that
joins them.

Port of ``medical_image_classification_tpu/kernels/stf_zgate_pallas.py``
(``stf_zgate_supported``, the forward body ``_fwd_kernel``, the backward
body ``_bwd_kernel`` and the custom VJP ``stf_zgate``).  Kernels:
``csrc/stf_zgate_fwd.cu`` and ``csrc/stf_zgate_bwd.cu``.

  Z = rnd(sigmoid(pooledT lz))  [P, P]  summed and gated in fp32, rounded
                                        to the operand dtype
  Y = Z U                       [P, C]  summed in fp32, written in
                                        pooledT's dtype

with pooledT [BB, P, C], lz [C, P] and U [BB, P, C].

The backward, at the TPU body's rounding points (dY taken to pooledT's
dtype; Z the fp32 gate):
  dU       = rnd(Z)^T dY
  dS       = rnd((dY U^T) * Z * (1 - Z))
  dpooledT = dS lz^T,  dlz = (sum over BB of dS^T pooledT)^T   fp32 sums,
                                                               rounded
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    resolve_impl,
)

_FWD_KERNEL = "stf_zgate_fwd"
_BWD_KERNEL = "stf_zgate_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this the JAX package keeps XLA's gate; a module constant so that
# tests can widen the gate to small shapes
_MIN_PP = 512 * 512
# channel widths the CUDA kernels are instantiated for (a block keeps one
# or two [64, C] fp32 accumulators)
KERNEL_C = (128, 256)


def stf_zgate_supported(P: int, C: int) -> bool:
    """The shape terms of the JAX gate (``stf_zgate_pallas.py:64-73``),
    without its backend term and its VMEM fit (``_pick_pt``)."""
    return P * P >= _MIN_PP and P % 8 == 0 and C % 128 == 0


def stf_zgate_fwd_ref(pooledT, lz, U):
    """Plain PyTorch version of the kernel (see the module docstring)."""
    mm = pooledT.dtype
    Z = torch.sigmoid(pooledT.float() @ lz.to(mm).float()).to(mm)
    return (Z.float() @ U.to(mm).float()).to(mm)


def stf_zgate_bwd_ref(pooledT, lz, U, dY):
    """Plain PyTorch version of the backward kernel: (dpooledT, dlz, dU),
    the cotangents of the forward's operands (see the module docstring)."""
    mm = pooledT.dtype
    p32, lz32 = pooledT.float(), lz.to(mm).float()
    dY32 = dY.to(mm).float()
    Z = torch.sigmoid(p32 @ lz32)                             # [BB, P, P]
    dU = (Z.to(mm).float().transpose(1, 2) @ dY32).to(U.dtype)
    dZ = dY32 @ U.to(mm).float().transpose(1, 2)
    dS = (dZ * Z * (1.0 - Z)).to(mm).float()
    dpT = (dS @ lz32.t()).to(pooledT.dtype)
    dlz = (dS.transpose(1, 2) @ p32).sum(0).t().to(lz.dtype)
    return dpT, dlz, dU


def _check_cuda_args(pooledT, lz, U, dY=None):
    if pooledT.dim() != 3 or lz.dim() != 2:
        raise ValueError(f"pooledT must be [BB, P, C] and lz [C, P], got "
                         f"{tuple(pooledT.shape)} and {tuple(lz.shape)}")
    BB, P, C = pooledT.shape
    if pooledT.dtype not in _DTYPES:
        raise TypeError(f"pooledT must be float32 or bfloat16, got "
                        f"{pooledT.dtype}")
    if C not in KERNEL_C or P % 8 or BB > 65535:
        raise ValueError(f"shape outside the kernel's limits: C={C} (one of "
                         f"{KERNEL_C}), P={P} (a multiple of 8), BB={BB}")
    named = [("lz", lz, (C, P)), ("U", U, (BB, P, C))]
    if dY is not None:
        named.append(("dY", dY, (BB, P, C)))
    for name, t, shape in named:
        if t.device != pooledT.device:
            raise ValueError(f"{name} is on {t.device}, pooledT on "
                             f"{pooledT.device}")
        if tuple(t.shape) != shape or t.dtype != pooledT.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {pooledT.dtype} {shape}")
    for name, t in [("pooledT", pooledT)] + [(n, t) for n, t, _ in named]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_fwd_cuda(pooledT, lz, U):
    """The forward kernel's wrapper: checks, allocates Y, launches on the
    current stream, counts the launch."""
    _check_cuda_args(pooledT, lz, U)
    BB, P, C = pooledT.shape
    Y = torch.empty_like(pooledT)
    with torch.cuda.device(pooledT.device):
        stream = torch.cuda.current_stream(pooledT.device).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p],
             [pooledT.data_ptr(), lz.data_ptr(), U.data_ptr(), Y.data_ptr(),
              BB, P, C, int(pooledT.dtype == torch.bfloat16), stream])
    stf_zgate_fwd.launches += 1
    return Y


def _launch_bwd_cuda(pooledT, lz, U, dY):
    """The backward kernel's wrapper: checks, allocates dpooledT, dU and the
    per-batch fp32 dlz partials [BB, P, C], launches, counts, and sums the
    partials over the batch (no atomics: the same bits on every run)."""
    _check_cuda_args(pooledT, lz, U, dY)
    BB, P, C = pooledT.shape
    dpT, dU = torch.empty_like(pooledT), torch.empty_like(U)
    dlz_part = torch.empty(BB, P, C, dtype=torch.float32,
                           device=pooledT.device)
    ptrs = [t.data_ptr() for t in (pooledT, lz, U, dY, dpT, dU, dlz_part)]
    with torch.cuda.device(pooledT.device):
        stream = torch.cuda.current_stream(pooledT.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 4
             + [ctypes.c_void_p],
             ptrs + [BB, P, C, int(pooledT.dtype == torch.bfloat16), stream])
    stf_zgate_bwd.launches += 1
    return dpT, dlz_part.sum(0).t().to(lz.dtype), dU


def stf_zgate_fwd(pooledT, lz, U, impl: str = "auto"):
    """Y = sigmoid(pooledT lz) U (see the module docstring).  ``impl``:
    "auto", "cuda" or "torch" (``kernels/_dispatch.py``)."""
    if resolve_impl(impl, pooledT, "STF gate") == "torch":
        return stf_zgate_fwd_ref(pooledT, lz, U)
    mm = pooledT.dtype
    return _launch_fwd_cuda(dense(pooledT), dense(lz.to(mm)),
                            dense(U.to(mm)))


def stf_zgate_bwd(pooledT, lz, U, dY, impl: str = "auto"):
    """The backward: (dpooledT, dlz, dU).  ``impl`` as in
    ``stf_zgate_fwd``."""
    if resolve_impl(impl, pooledT, "STF gate") == "torch":
        return stf_zgate_bwd_ref(pooledT, lz, U, dY)
    mm = pooledT.dtype
    return _launch_bwd_cuda(dense(pooledT), dense(lz.to(mm)),
                            dense(U.to(mm)), dense(dY.to(mm)))


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
stf_zgate_fwd.launches = 0
stf_zgate_bwd.launches = 0


class STFZGate(torch.autograd.Function):
    """``stf_zgate`` under autograd (the JAX custom VJP): the backward
    takes the cotangent to pooledT's dtype and runs the backward kernel or
    the plain backward by the same ``impl``."""

    @staticmethod
    def forward(ctx, pooledT, lz, U, impl):
        ctx.save_for_backward(pooledT, lz, U)
        ctx.impl = impl
        return stf_zgate_fwd(pooledT, lz, U, impl=impl)

    @staticmethod
    def backward(ctx, dY):
        pooledT, lz, U = ctx.saved_tensors
        return stf_zgate_bwd(pooledT, lz, U, dY.to(pooledT.dtype),
                             impl=ctx.impl) + (None,)


def stf_zgate(pooledT, lz, U, impl: str = "auto"):
    """Y = sigmoid(pooledT lz) U [BB, P, C]: pooledT [BB, P, C], lz [C, P],
    U [BB, P, C].  The caller has checked ``stf_zgate_supported``.  With
    grad enabled and an operand that requires grad, the call goes through
    ``STFZGate``; otherwise only the forward runs."""
    impl = resolve_impl(impl, pooledT, "STF gate")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (pooledT, lz, U)):
        return STFZGate.apply(pooledT, lz, U, impl)
    return stf_zgate_fwd(pooledT, lz, U, impl=impl)
