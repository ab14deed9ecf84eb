"""The ST-SSD semantic-token mixer: the gate, the plain forward and
backward, the CUDA kernels' wrappers and dispatchers, and the autograd
Function that joins them.

Port of ``medical_image_classification_tpu/kernels/stl_mixer_pallas.py``
(``stl_mixer_supported``, ``stl_mixer``, the forward body ``_fwd_kernel``,
the backward body ``_bwd_kernel`` and the custom VJP ``_mixer``).  Kernels:
``csrc/stl_mixer_fwd.cu`` and ``csrc/stl_mixer_bwd.cu``.

  S = w u1            [L, P]  summed in fp32 over operand-type values
  E = softmax_P(S)            in fp32, then rounded to the operand dtype
  U = E^T V           [P, C]  summed in fp32, written in w's dtype

with w [BB, L, C] (the four directions folded into the batch), u1 [C, P],
V = w u2 [BB, L, C] (a plain matmul outside the kernel, as the JAX caller
computes it) and U [BB, P, C].

The backward, at the TPU body's rounding points (dU taken to w's dtype):
  dV  = rnd(E) dU                       E the fp32 softmax
  dE  = V dU^T,  rowdot = rowsums(E * dE)
  dS  = rnd(E * (dE - rowdot))
  dw  = dS u1^T,  du1 = (sum over BB of dS^T w)^T    fp32 sums, rounded
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    resolve_impl,
)

_FWD_KERNEL = "stl_mixer_fwd"
_BWD_KERNEL = "stl_mixer_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this much mixer work the JAX package keeps XLA's softmax; a module
# constant so that tests can widen the gate to small shapes
_MIN_LP = 512 * 512
# channel widths the CUDA kernels are instantiated for (a block keeps one
# or two [64, C] fp32 accumulators)
KERNEL_C = (128, 256)


def stl_mixer_supported(L: int, P: int, C: int) -> bool:
    """The shape terms of the JAX gate (``stl_mixer_pallas.py:73-82``),
    without its backend term and its VMEM fit (``_pick_lt``)."""
    return L * P >= _MIN_LP and L % 8 == 0 and P % 8 == 0 and C % 128 == 0


def stl_mixer_fwd_ref(w, u1, V):
    """Plain PyTorch version of the kernel (see the module docstring)."""
    mm = w.dtype
    E = torch.softmax(w.float() @ u1.to(mm).float(), dim=-1).to(mm)
    return (E.float().transpose(1, 2) @ V.to(mm).float()).to(mm)


def stl_mixer_bwd_ref(w, u1, V, dU):
    """Plain PyTorch version of the backward kernel: (dw, du1, dV), the
    cotangents of the forward's operands (see the module docstring)."""
    mm = w.dtype
    w32, u132 = w.float(), u1.to(mm).float()
    dU32 = dU.to(mm).float()
    E = torch.softmax(w32 @ u132, dim=-1)                     # [BB, L, P]
    dV = (E.to(mm).float() @ dU32).to(V.dtype)
    dE = V.to(mm).float() @ dU32.transpose(1, 2)
    dS = (E * (dE - (E * dE).sum(-1, keepdim=True))).to(mm).float()
    dw = (dS @ u132.t()).to(w.dtype)
    du1 = (dS.transpose(1, 2) @ w32).sum(0).t().to(u1.dtype)
    return dw, du1, dV


def _check_cuda_args(w, u1, V, dU=None):
    if w.dim() != 3 or u1.dim() != 2:
        raise ValueError(f"w must be [BB, L, C] and u1 [C, P], got "
                         f"{tuple(w.shape)} and {tuple(u1.shape)}")
    BB, L, C = w.shape
    P = u1.shape[1]
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if C not in KERNEL_C or P % 8 or BB > 65535:
        raise ValueError(f"shape outside the kernel's limits: C={C} (one of "
                         f"{KERNEL_C}), P={P} (a multiple of 8), BB={BB}")
    named = [("u1", u1, (C, P)), ("V", V, (BB, L, C))]
    if dU is not None:
        named.append(("dU", dU, (BB, P, C)))
    for name, t, shape in named:
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if tuple(t.shape) != shape or t.dtype != w.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {w.dtype} {shape}")
    for name, t in [("w", w)] + [(n, t) for n, t, _ in named]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_fwd_cuda(w, u1, V):
    """The forward kernel's wrapper: checks, allocates U and the [2, BB, L]
    fp32 row statistics (max and sum of the softmax rows), launches on the
    current stream, counts the launch."""
    _check_cuda_args(w, u1, V)
    BB, L, C = w.shape
    P = u1.shape[1]
    U = torch.empty(BB, P, C, dtype=w.dtype, device=w.device)
    stats = torch.empty(2, BB, L, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             [w.data_ptr(), u1.data_ptr(), V.data_ptr(), U.data_ptr(),
              stats.data_ptr(), BB, L, P, C, int(w.dtype == torch.bfloat16),
              stream])
    stl_mixer_fwd.launches += 1
    return U


def _launch_bwd_cuda(w, u1, V, dU):
    """The backward kernel's wrapper: checks, allocates dw, dV, the
    [3, BB, L] fp32 row workspace (max, sum and rowdot of the softmax rows)
    and the per-batch fp32 du1 partials [BB, P, C], launches, counts, and
    sums the partials over the batch (no atomics: the same bits on every
    run)."""
    _check_cuda_args(w, u1, V, dU)
    BB, L, C = w.shape
    P = u1.shape[1]
    f32 = dict(dtype=torch.float32, device=w.device)
    dw, dV = torch.empty_like(w), torch.empty_like(V)
    rows = torch.empty(3, BB, L, **f32)
    du1_part = torch.empty(BB, P, C, **f32)
    ptrs = [t.data_ptr() for t in (w, u1, V, dU, dw, dV, rows, du1_part)]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             ptrs + [BB, L, P, C, int(w.dtype == torch.bfloat16), stream])
    stl_mixer_bwd.launches += 1
    return dw, du1_part.sum(0).t().to(u1.dtype), dV


def stl_mixer_fwd(w, u1, V, impl: str = "auto"):
    """U = softmax_P(w u1)^T V (see the module docstring).  ``impl``:
    "auto", "cuda" or "torch" (``kernels/_dispatch.py``)."""
    if resolve_impl(impl, w, "STL mixer") == "torch":
        return stl_mixer_fwd_ref(w, u1, V)
    return _launch_fwd_cuda(dense(w), dense(u1.to(w.dtype)),
                            dense(V.to(w.dtype)))


def stl_mixer_bwd(w, u1, V, dU, impl: str = "auto"):
    """The backward: (dw, du1, dV).  ``impl`` as in ``stl_mixer_fwd``."""
    if resolve_impl(impl, w, "STL mixer") == "torch":
        return stl_mixer_bwd_ref(w, u1, V, dU)
    mm = w.dtype
    return _launch_bwd_cuda(dense(w), dense(u1.to(mm)), dense(V.to(mm)),
                            dense(dU.to(mm)))


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
stl_mixer_fwd.launches = 0
stl_mixer_bwd.launches = 0


class STLMixer(torch.autograd.Function):
    """``softmax_P(w u1)^T V`` under autograd (the JAX custom VJP
    ``_mixer``): the backward takes the cotangent to w's dtype and runs the
    backward kernel or the plain backward by the same ``impl``.  Nothing of
    the forward is saved but its operands: the backward recomputes the
    softmax rows' max and sum in its own row pass, which it needs anyway
    for rowdot."""

    @staticmethod
    def forward(ctx, w, u1, V, impl):
        ctx.save_for_backward(w, u1, V)
        ctx.impl = impl
        return stl_mixer_fwd(w, u1, V, impl=impl)

    @staticmethod
    def backward(ctx, dU):
        w, u1, V = ctx.saved_tensors
        return stl_mixer_bwd(w, u1, V, dU.to(w.dtype),
                             impl=ctx.impl) + (None,)


def stl_mixer(w, u1, u2, impl: str = "auto"):
    """The fused token mixer ``softmax_P(w u1)^T (w u2)``: w [BB, L, C],
    u1 [C, P], u2 [C, C] -> U [BB, P, C].  The caller has checked
    ``stl_mixer_supported``.  V = w u2 is a plain matmul outside the
    kernels, as in the JAX package, so autograd carries dV on to dw and
    du2.  With grad enabled and an operand that requires grad, the mixer
    goes through ``STLMixer``; otherwise only the forward runs."""
    impl = resolve_impl(impl, w, "STL mixer")
    V = torch.matmul(w, u2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, u1, V)):
        return STLMixer.apply(w, u1, V, impl)
    return stl_mixer_fwd(w, u1, V, impl=impl)
