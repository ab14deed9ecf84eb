"""The selective-scan kernel bench's calibration floor: plain version, CUDA
kernel wrapper, and the dispatcher between them.

Port of the Pallas kernel that ``scripts/kernel_bench.py::
calib_kernel_bench`` builds (its body ``kern``, launched by ``run``): the
scan forward's irreducible per-element work without the scan (an exp, four
products and a sum over the N states), so that the bench can set the scan
kernels' times against it.  No bias: dt = softplus(Δ).

Layout: u, Δ [G, L, Dm] and B, C [G, L, N] in one type; At [K, N, Dm] fp32
(A transposed, as ``run`` takes it), sequence g in group g % K.  y is [G,
Lp, Dm] in u's type, L padded to Lp, the next multiple of the bench's chunk
T, as the TPU kernel writes it; the pad rows are 0.

Two plain versions: ``scan_calib_ref`` computes in ``kern``'s order (and,
with ``bf16_compute``, rounds where it rounds); ``scan_calib_factored_ref``
is the fp32 order of the CUDA kernel (``csrc/scan_calib.cu``), dt u taken
out of the sum and B C formed once, against which ``chip_smoke.py`` holds
the kernel's fp32 compute on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    resolve_impl,
)

_KERNEL = "scan_calib"
_DTYPES = (torch.float32, torch.bfloat16)
LOG2E = 1.4426950408889634      # the kernel's kLog2e, rounded to fp32


def scan_calib_ref(u, delta, At, B, C, T: int, bf16_compute: bool = False):
    """Plain PyTorch version of ``kern``: in ``bf16_compute`` every operand
    is cast to bf16 and softplus, exp and each product rounded to bf16 (the
    product C (a b) cast to fp32 before the sum), else all in fp32; the sum
    over n in fp32, in order."""
    G, L, Dm = u.shape
    K, N, _ = At.shape
    pad = (-L) % T
    cdt = torch.bfloat16 if bf16_compute else torch.float32
    uf = F.pad(u.to(cdt), (0, 0, 0, pad))
    dt = F.softplus(F.pad(delta.to(cdt), (0, 0, 0, pad)))
    Bv, Cv = (F.pad(t.to(cdt), (0, 0, 0, pad)) for t in (B, C))
    Av = At.to(cdt).repeat(G // K, 1, 1)                   # [G, N, Dm]
    dtu = dt * uf
    acc = torch.zeros(G, L + pad, Dm, dtype=torch.float32, device=u.device)
    for n in range(N):
        a = torch.exp(dt * Av[:, None, n])
        acc += (Cv[..., n:n + 1] * (a * (dtu * Bv[..., n:n + 1]))).float()
    return acc.to(u.dtype)


def scan_calib_factored_ref(u, delta, At, B, C, T: int):
    """Plain PyTorch version of the kernel's fp32 compute, in its order:
    y = (dt u) sum_n 2^(dt A'_n) (B_n C_n), with A' = A log2 e rounded to
    fp32 and B C formed once a (t, n); the sum over n in fp32, in order.
    The same function as ``scan_calib_ref``'s fp32 compute, its roundings
    taken in another order."""
    G, L, Dm = u.shape
    K = At.shape[0]
    pad = (-L) % T
    dt = F.softplus(delta.float())
    A2 = (At * torch.tensor(LOG2E, dtype=torch.float32)).repeat(G // K, 1, 1)
    BC = B.float() * C.float()                             # [G, L, N]
    acc = torch.zeros(G, L, Dm, dtype=torch.float32, device=u.device)
    for n in range(At.shape[1]):
        acc += torch.exp2(dt * A2[:, None, n]) * BC[..., n:n + 1]
    return F.pad((dt * u.float()) * acc, (0, 0, 0, pad)).to(u.dtype)


def _check_cuda_args(u, delta, At, B, C, T):
    G, L, Dm = u.shape
    K, N, _ = At.shape
    # the C entry refuses every size below 1
    for name, size in (("G", G), ("L", L), ("Dm", Dm), ("K", K), ("N", N)):
        if size < 1:
            raise ValueError(f"{name}={size}: every size must be at least 1")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    for name, t, shape, dtype in (("delta", delta, (G, L, Dm), u.dtype),
                                  ("At", At, (K, N, Dm), torch.float32),
                                  ("B", B, (G, L, N), u.dtype),
                                  ("C", C, (G, L, N), u.dtype)):
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
    if G % K:
        raise ValueError(f"G={G} must be a multiple of K={K}")
    if not isinstance(T, int) or T < 1:
        raise ValueError(f"chunk T must be a positive int, got {T!r}")


def _launch_cuda(u, delta, At, B, C, T, bf16_compute):
    """The kernel wrapper: checks, allocates y [G, Lp, Dm], launches
    csrc/scan_calib.cu on the current stream and counts the launch."""
    _check_cuda_args(u, delta, At, B, C, T)
    G, L, Dm = u.shape
    K, N, _ = At.shape
    Lp = -(-L // T) * T
    y = torch.empty(G, Lp, Dm, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             [u.data_ptr(), delta.data_ptr(), At.data_ptr(), B.data_ptr(),
              C.data_ptr(), y.data_ptr(), G, L, Lp, Dm, K, N,
              int(u.dtype == torch.bfloat16), int(bf16_compute), stream])
    scan_calib.launches += 1
    return y


def pass_info(G: int, Lp: int, Dm: int, dtype, bf16_compute: bool) -> dict:
    """What the card grants the kernel's one pass at (G, Lp, Dm), operand
    type ``dtype`` and the compute: {"registers", "local_bytes" (spills),
    "shared_bytes" a block, "warps_per_sm", "threads" a block, "rows" a
    tile, "blocks"}, from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from medical_image_classification_tpu_torch.kernels import _build
    lib = _build.library(_KERNEL)
    fn = getattr(lib, f"{_KERNEL}_pass_info")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    _build.raise_on_error(lib, _KERNEL, fn(
        G, Lp, Dm, int(dtype == torch.bfloat16), int(bf16_compute),
        ctypes.addressof(out)))
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "warps_per_sm", "threads", "rows", "blocks"), out))


def scan_calib(u, delta, At, B, C, T: int, bf16_compute: bool = False,
               impl: str = "auto"):
    """The calibration floor, y [G, Lp, Dm] in u's type.  ``impl``:
    "auto" takes the CUDA kernel for a CUDA tensor and the plain version
    for a CPU tensor; "cuda" launches the kernel or raises; "torch" runs
    the plain version on any device."""
    if resolve_impl(impl, u, "calibration") == "torch":
        return scan_calib_ref(u, delta, At, B, C, T, bf16_compute)
    return _launch_cuda(u, delta, At, B, C, T, bf16_compute)


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_calib.launches = 0
