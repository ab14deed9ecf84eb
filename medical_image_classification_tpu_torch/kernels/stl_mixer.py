"""The ST-SSD semantic-token mixer: the gate, the plain version, the CUDA
kernel's wrapper and the dispatcher.

Port of ``medical_image_classification_tpu/kernels/stl_mixer_pallas.py``
(``stl_mixer_supported``, ``stl_mixer`` and the forward body
``_fwd_kernel``).  Kernel: ``csrc/stl_mixer_fwd.cu``.  Forward only: the
backward kernel comes with ST-SSD training (ROADMAP.md Queue 2, row 8b).

  S = w u1            [L, P]  summed in fp32 over operand-type values
  E = softmax_P(S)            in fp32, then rounded to the operand dtype
  U = E^T V           [P, C]  summed in fp32, written in w's dtype

with w [BB, L, C] (the four directions folded into the batch), u1 [C, P],
V = w u2 [BB, L, C] (a plain matmul outside the kernel, as the JAX caller
computes it) and U [BB, P, C].
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

_KERNEL = "stl_mixer_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this much mixer work the JAX package keeps XLA's softmax; a module
# constant so that tests can widen the gate to small shapes
_MIN_LP = 512 * 512
# channel widths the CUDA kernel is instantiated for (a block keeps a
# [64, C] fp32 accumulator)
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


def _check_cuda_args(w, u1, V):
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
    for name, t, shape in (("u1", u1, (C, P)), ("V", V, (BB, L, C))):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if tuple(t.shape) != shape or t.dtype != w.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {w.dtype} {shape}")
    for name, t in (("w", w), ("u1", u1), ("V", V)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_cuda(w, u1, V):
    """The kernel's wrapper: checks, allocates U and the [2, BB, L] fp32
    row statistics (max and sum of the softmax rows), launches on the
    current stream, counts the launch."""
    _check_cuda_args(w, u1, V)
    BB, L, C = w.shape
    P = u1.shape[1]
    U = torch.empty(BB, P, C, dtype=w.dtype, device=w.device)
    stats = torch.empty(2, BB, L, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             [w.data_ptr(), u1.data_ptr(), V.data_ptr(), U.data_ptr(),
              stats.data_ptr(), BB, L, P, C, int(w.dtype == torch.bfloat16),
              stream])
    stl_mixer_fwd.launches += 1
    return U


def stl_mixer_fwd(w, u1, V, impl: str = "auto"):
    """U = softmax_P(w u1)^T V (see the module docstring).  ``impl``:
    "auto", "cuda" or "torch" (``kernels/_dispatch.py``); the CUDA kernel
    refuses an input that autograd would differentiate."""
    if resolve_impl(impl, w, "STL mixer") == "torch":
        return stl_mixer_fwd_ref(w, u1, V)
    refuse_grad("STL mixer", w, u1, V)
    return _launch_cuda(dense(w), dense(u1.to(w.dtype)),
                        dense(V.to(w.dtype)))


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
stl_mixer_fwd.launches = 0


def stl_mixer(w, u1, u2, impl: str = "auto"):
    """The fused token mixer ``softmax_P(w u1)^T (w u2)``: w [BB, L, C],
    u1 [C, P], u2 [C, C] -> U [BB, P, C].  The caller has checked
    ``stl_mixer_supported``."""
    return stl_mixer_fwd(w, u1, torch.matmul(w, u2), impl=impl)
