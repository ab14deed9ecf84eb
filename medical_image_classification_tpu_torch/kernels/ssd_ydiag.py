"""The SSD intra-chunk output Y_diag: the gate, the plain version, the CUDA
kernel's wrapper and the dispatcher.

Port of ``medical_image_classification_tpu/kernels/ssd_ydiag_pallas.py``
(``ydiag_supported`` and the forward body ``_fwd_kernel``).  Kernel:
``csrc/ssd_ydiag_fwd.cu``.  Forward only: the backward kernel comes with
ST-SSD training (ROADMAP.md Queue 2, row 7b).

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

_KERNEL = "ssd_ydiag_fwd"
_DTYPES = (torch.float32, torch.bfloat16)
# The chunk window of the gate; module constants so that tests can widen
# it to small shapes, as the JAX package's tests patch its ``_MIN_L``.
_MIN_L = 224
_MAX_L = 256
# shape limit of the CUDA kernel: a block holds two [64, N] row tiles
MAX_N = 256


def ydiag_supported(l: int, N: int, P: int, G: int) -> bool:
    """The shape terms of the JAX gate (``ssd_ydiag_pallas.py:127-128``),
    without its backend term and its VMEM fit (``_pick_hb``)."""
    return (G == 1 and _MIN_L <= l <= _MAX_L and l % 8 == 0 and N % 64 == 0
            and P % 8 == 0)


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


def _check_cuda_args(Cc, Bc, acum, dtx):
    if Cc.dim() != 3 or dtx.dim() != 4:
        raise ValueError(f"Cc must be [BC, l, N] and dtx [BC, H, l, P], got "
                         f"{tuple(Cc.shape)} and {tuple(dtx.shape)}")
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    if Cc.dtype not in _DTYPES or dtx.dtype != Cc.dtype:
        raise TypeError(f"Cc and dtx must both be float32 or bfloat16, got "
                        f"{Cc.dtype} and {dtx.dtype}")
    if N > MAX_N or BC > 65535:
        raise ValueError(f"shape outside the kernel's limits: N={N} (<= "
                         f"{MAX_N}), BC={BC} (<= 65535)")
    for name, t, shape, dtype in (("Bc", Bc, (BC, l, N), Cc.dtype),
                                  ("acum", acum, (BC, H, l), torch.float32),
                                  ("dtx", dtx, (BC, H, l, P), Cc.dtype)):
        if t.device != Cc.device:
            raise ValueError(f"{name} is on {t.device}, Cc on {Cc.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for name, t in (("Cc", Cc), ("Bc", Bc), ("acum", acum), ("dtx", dtx)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_cuda(Cc, Bc, acum, dtx):
    """The kernel's wrapper: checks, allocates y, launches on the current
    stream, counts the launch."""
    _check_cuda_args(Cc, Bc, acum, dtx)
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    y = torch.empty_like(dtx)
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_void_p],
             [Cc.data_ptr(), Bc.data_ptr(), acum.data_ptr(), dtx.data_ptr(),
              y.data_ptr(), BC, l, N, H, P, int(Cc.dtype == torch.bfloat16),
              stream])
    ydiag_fused.launches += 1
    return y


def ydiag_fused(Cc, Bc, acum, dtx, impl: str = "auto"):
    """Y_diag [BC, H, l, P] (see the module docstring).  ``impl``: "auto",
    "cuda" or "torch" (``kernels/_dispatch.py``); the CUDA kernel refuses
    an input that autograd would differentiate."""
    if resolve_impl(impl, Cc, "Y_diag") == "torch":
        return ydiag_fused_ref(Cc, Bc, acum, dtx)
    refuse_grad("Y_diag", Cc, Bc, acum, dtx)
    return _launch_cuda(dense(Cc), dense(Bc), dense(acum.float()),
                        dense(dtx))


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
ydiag_fused.launches = 0
