"""The ST-SSD fusion gate: the gate, the plain version, the CUDA kernel's
wrapper and the dispatcher.

Port of ``medical_image_classification_tpu/kernels/stf_zgate_pallas.py``
(``stf_zgate_supported`` and the forward body ``_fwd_kernel``).  Kernel:
``csrc/stf_zgate_fwd.cu``.  Forward only: the backward kernel comes with
ST-SSD training (ROADMAP.md Queue 2, row 9b).

  Z = rnd(sigmoid(pooledT lz))  [P, P]  summed and gated in fp32, rounded
                                        to the operand dtype
  Y = Z U                       [P, C]  summed in fp32, written in
                                        pooledT's dtype

with pooledT [BB, P, C], lz [C, P] and U [BB, P, C].
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    refuse_grad,
    resolve_impl,
)

_KERNEL = "stf_zgate_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this the JAX package keeps XLA's gate; a module constant so that
# tests can widen the gate to small shapes
_MIN_PP = 512 * 512
# channel widths the CUDA kernel is instantiated for (a block keeps a
# [64, C] fp32 accumulator)
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


def _check_cuda_args(pooledT, lz, U):
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
    for name, t, shape in (("lz", lz, (C, P)), ("U", U, (BB, P, C))):
        if t.device != pooledT.device:
            raise ValueError(f"{name} is on {t.device}, pooledT on "
                             f"{pooledT.device}")
        if tuple(t.shape) != shape or t.dtype != pooledT.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {pooledT.dtype} {shape}")
    for name, t in (("pooledT", pooledT), ("lz", lz), ("U", U)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_cuda(pooledT, lz, U):
    """The kernel's wrapper: checks, allocates Y, launches on the current
    stream, counts the launch."""
    _check_cuda_args(pooledT, lz, U)
    BB, P, C = pooledT.shape
    Y = torch.empty_like(pooledT)
    with torch.cuda.device(pooledT.device):
        stream = torch.cuda.current_stream(pooledT.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p],
             [pooledT.data_ptr(), lz.data_ptr(), U.data_ptr(), Y.data_ptr(),
              BB, P, C, int(pooledT.dtype == torch.bfloat16), stream])
    stf_zgate_fwd.launches += 1
    return Y


def stf_zgate_fwd(pooledT, lz, U, impl: str = "auto"):
    """Y = sigmoid(pooledT lz) U (see the module docstring).  ``impl``:
    "auto", "cuda" or "torch" (``kernels/_dispatch.py``); the CUDA kernel
    refuses an input that autograd would differentiate."""
    if resolve_impl(impl, pooledT, "STF gate") == "torch":
        return stf_zgate_fwd_ref(pooledT, lz, U)
    refuse_grad("STF gate", pooledT, lz, U)
    mm = pooledT.dtype
    return _launch_cuda(dense(pooledT), dense(lz.to(mm)), dense(U.to(mm)))


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
stf_zgate_fwd.launches = 0
