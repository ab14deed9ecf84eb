"""Selective-scan forward in the folded layout: plain version, CUDA kernel
wrapper, and the dispatcher between them.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py``
``selective_scan_pallas_folded`` and the forward kernel behind it
(``selective_scan_pallas_v2.py::fwd_folded_v2``), for ``want_state=False``
and no initial state.

Folded layout (what ``ops.ss2d.ss2d_core_mamba1`` produces):
  u, delta : [G, L, Dm]    G = batch * K, batch-major
  A        : [K, Dm, N]    per-direction decay (param group = g % K)
  B, C     : [G, L, N]
  D, bias  : [K, Dm]
y has u's dtype; the state and all accumulation are fp32.
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels.selective_scan import (
    selective_scan_seq,
)

_KERNEL = "selective_scan_fwd"
_MAX_N = 64
_DTYPES = (torch.float32, torch.bfloat16)


def scan_folded_fwd_ref(u, delta, A, B, C, D, bias, reverse: bool = False,
                        softplus: bool = True):
    """Plain PyTorch version: unfold into the generic layout and run the
    sequential golden model (``reverse`` = flip, scan, flip back)."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    batch = G // K
    if reverse:
        u, delta, B, C = (torch.flip(t, dims=(1,)) for t in (u, delta, B, C))

    def unfold(t, width):       # [G, L, w] -> [batch, L, K, w]
        return t.reshape(batch, K, L, width).transpose(1, 2)

    y = selective_scan_seq(
        unfold(u, Dm).reshape(batch, L, K * Dm),
        unfold(delta, Dm).reshape(batch, L, K * Dm),
        A.reshape(K * Dm, N), unfold(B, N), unfold(C, N),
        D=D.reshape(-1), delta_bias=bias.reshape(-1), delta_softplus=softplus)
    y = y.reshape(batch, L, K, Dm).transpose(1, 2).reshape(G, L, Dm)
    if reverse:
        y = torch.flip(y, dims=(1,))
    return y


def _check_cuda_args(u, delta, A, B, C, D, bias):
    G, L, Dm = u.shape
    K, _, N = A.shape
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    for name, t, shape, dtype in (
            ("delta", delta, (G, L, Dm), u.dtype),
            ("A", A, (K, Dm, N), torch.float32),
            ("B", B, (G, L, N), u.dtype),
            ("C", C, (G, L, N), u.dtype),
            ("D", D, (K, Dm), torch.float32),
            ("bias", bias, (K, Dm), torch.float32)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if N > _MAX_N:
        raise ValueError(f"d_state N={N} exceeds the kernel's limit "
                         f"{_MAX_N}")
    if G % K or G > 65535:
        raise ValueError(f"G={G} must be a multiple of K={K} and <= 65535")


def _launch_cuda(u, delta, A, B, C, D, bias, reverse, softplus):
    from medical_image_classification_tpu_torch.kernels import _build

    _check_cuda_args(u, delta, A, B, C, D, bias)
    lib = _build.library(_KERNEL)
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    G, L, Dm = u.shape
    K, _, N = A.shape
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
                G, L, Dm, K, N, int(u.dtype == torch.bfloat16), int(reverse),
                int(softplus), stream)
    if rc != 0:
        err = lib.selective_scan_fwd_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    scan_folded_fwd.launches += 1
    return y


def scan_folded_fwd(u, delta, A, B, C, D, bias, reverse: bool = False,
                    softplus: bool = True, impl: str = "auto"):
    """Folded selective-scan forward.

    ``impl``: ``"auto"`` takes the CUDA kernel for a CUDA tensor and the
    plain version for a CPU tensor; ``"cuda"`` launches the kernel or
    raises; ``"torch"`` runs the plain version on any device.  The kernel
    never falls back: a failed build or launch raises.  Parameters (A, D,
    bias) are cast to fp32 here, as the JAX entry does.
    """
    if impl == "auto":
        impl = "cuda" if u.is_cuda else "torch"
    A, D, bias = (t.float().contiguous() for t in (A, D, bias))
    if impl == "torch":
        return scan_folded_fwd_ref(u, delta, A, B, C, D, bias,
                                   reverse=reverse, softplus=softplus)
    if impl == "cuda":
        if not u.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; u is on "
                             f"{u.device}")
        return _launch_cuda(u, delta, A, B, C, D, bias, reverse, softplus)
    raise ValueError(f"unknown scan impl: {impl!r} "
                     "(expected 'auto', 'cuda' or 'torch')")


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_folded_fwd.launches = 0
