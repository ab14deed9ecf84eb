"""The ST-SSD fusion gate: the gate, the plain forward and backward, the
CUDA kernels' wrappers and dispatchers, and the autograd Function that
joins them.

Port of ``medical_image_classification_tpu/kernels/stf_zgate_pallas.py``
(``stf_zgate_supported``, the forward body ``_fwd_kernel``, the backward
body ``_bwd_kernel`` and the custom VJP ``stf_zgate``).  Kernels:
``csrc/stf_zgate_fwd.cu`` (one rows pass) and ``csrc/stf_zgate_bwd.cu``
(a rows pass and a columns pass), on ``csrc/stf_zgate_tiles.cuh``.

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

from medical_image_classification_tpu_torch.kernels import ops
from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    pass_info,
    resolve_impl,
    via_op,
)
# the kernels' step along the walked axis: the gate's passes run on the
# mixer's tiles (Cfg::kStep), and the decomposition twins follow it
from medical_image_classification_tpu_torch.kernels.stl_mixer import STEP

_FWD_KERNEL = "stf_zgate_fwd"
_BWD_KERNEL = "stf_zgate_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this the JAX package keeps XLA's gate; a module constant so that
# tests can widen the gate to small shapes
_MIN_PP = 512 * 512
# channel widths the CUDA kernels are instantiated for (a warp holds 16
# output rows of 128 (bf16) or 64 (fp32) channels in fp32 registers)
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


def stf_zgate_fwd_passes_ref(pooledT, lz, U):
    """The forward kernel's decomposition (``csrc/stf_zgate_fwd.cu``) in
    plain PyTorch: the rows pass's Y = sum over steps of q of
    rnd(sigmoid(pooledT lz_q)) U_q, each step's product summed in fp32
    (the last step cut at P, where the kernel sets Z to 0)."""
    mm = pooledT.dtype
    BB, P, C = pooledT.shape
    step = STEP[mm]
    p32, lz32, U32 = pooledT.float(), lz.to(mm).float(), U.to(mm).float()
    Y = torch.zeros(BB, P, C, device=pooledT.device)
    for q0 in range(0, P, step):
        q = slice(q0, q0 + step)
        Z = torch.sigmoid(p32 @ lz32[:, q]).to(mm).float()
        Y += Z @ U32[:, q]
    return Y.to(mm)


def stf_zgate_bwd_passes_ref(pooledT, lz, U, dY):
    """The backward kernels' decomposition (``csrc/stf_zgate_bwd.cu``) in
    plain PyTorch: (dpooledT, dlz, dU).  Rows pass over steps of q:
    dpooledT += dS_q lz_q^T; columns pass over steps of i: dU += rnd(Z_i)^T
    dY_i and the per-batch dlz partials += dS_i^T pooledT_i, summed over
    the batch at the end; dS = rnd(dZ Z (1 - Z)) from the fp32 Z."""
    mm = pooledT.dtype
    BB, P, C = pooledT.shape
    step = STEP[mm]
    p32, lz32 = pooledT.float(), lz.to(mm).float()
    U32, dY32 = U.to(mm).float(), dY.to(mm).float()

    def tile(rows, cols):
        Z = torch.sigmoid(p32[:, rows] @ lz32[:, cols])
        dZ = dY32[:, rows] @ U32[:, cols].transpose(1, 2)
        return Z, (dZ * Z * (1.0 - Z)).to(mm).float()

    f32 = dict(dtype=torch.float32, device=pooledT.device)
    dpT = torch.zeros(BB, P, C, **f32)
    for q0 in range(0, P, step):
        q = slice(q0, q0 + step)
        dpT += tile(slice(None), q)[1] @ lz32[:, q].t()
    dU, dlzp = torch.zeros(BB, P, C, **f32), torch.zeros(BB, P, C, **f32)
    for i0 in range(0, P, step):
        i = slice(i0, i0 + step)
        Z, dS = tile(i, slice(None))
        dU += Z.to(mm).float().transpose(1, 2) @ dY32[:, i]
        dlzp += dS.transpose(1, 2) @ p32[:, i]
    return (dpT.to(pooledT.dtype), dlzp.sum(0).t().to(lz.dtype),
            dU.to(U.dtype))


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


def fwd_pass_info(C: int, dtype) -> dict:
    """What the card grants the forward's pass at channels ``C`` and
    operand type ``dtype`` (``_dispatch.pass_info``): {"rows":
    (registers, local bytes, shared bytes, warps per SM)}."""
    return pass_info(_FWD_KERNEL, ("rows",), C, dtype)


def bwd_pass_info(C: int, dtype) -> dict:
    """The same for the backward's passes, "rows" and "cols"."""
    return pass_info(_BWD_KERNEL, ("rows", "cols"), C, dtype)


def stf_zgate_fwd(pooledT, lz, U, impl: str = "auto"):
    """Y = sigmoid(pooledT lz) U (see the module docstring).  ``impl``:
    "auto", "cuda" or "torch" (``kernels/_dispatch.py``)."""
    impl = resolve_impl(impl, pooledT, "STF gate")
    if not via_op(impl, pooledT):
        return stf_zgate_fwd_ref(pooledT, lz, U)
    return ops.stf_zgate_fwd(pooledT, lz, U, impl)


def op_forward(pooledT, lz, U, impl):
    """The body of ``ops.stf_zgate_fwd``: the kernel (``impl`` "cuda";
    on dense copies in pooledT's dtype) or the plain version ("torch")."""
    if impl == "cuda":
        mm = pooledT.dtype
        return _launch_fwd_cuda(dense(pooledT), dense(lz.to(mm)),
                                dense(U.to(mm)))
    return stf_zgate_fwd_ref(pooledT, lz, U)


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
