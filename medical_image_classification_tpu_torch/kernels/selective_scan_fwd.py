"""Selective-scan forward in the folded layout: plain version, CUDA kernel
wrapper, and the dispatcher between them.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py``
``selective_scan_pallas_folded`` and the forward kernel behind it
(``selective_scan_pallas_v2.py::fwd_folded_v2``), for ``want_state=False``
and no initial state.  Under autograd the dispatcher goes through
``kernels/selective_scan_bwd.py::ScanFolded``, which saves the forward's
``xsave`` (the fp32 state entering each chunk of ``CHUNK`` timesteps) for
the backward.

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

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    resolve_impl,
)
from medical_image_classification_tpu_torch.kernels.selective_scan import (
    selective_scan_seq,
)

_KERNEL = "selective_scan_fwd"
_MAX_N = 64
_DTYPES = (torch.float32, torch.bfloat16)
# Timesteps per chunk of xsave, shared by the forward and backward kernels
# (kChunk in csrc/): the backward keeps one chunk's states in shared memory
# (32 x N 16 x 32 channels x 4 B = 64 KB), and xsave costs 4 B x N per
# channel per 32 steps, a third of the forward's bf16 bytes.  The TPU's
# _choose_tiles T was sized for VMEM and does not apply.
CHUNK = 32


def scan_folded_fwd_ref(u, delta, A, B, C, D, bias, reverse: bool = False,
                        softplus: bool = True, want_xsave: bool = False,
                        chunk: int = CHUNK):
    """Plain PyTorch version: unfold into the generic layout and run the
    sequential golden model (``reverse`` = flip, scan, flip back).

    ``want_xsave`` also returns xsave [G, ceil(L / chunk), N, Dm] fp32, the
    state entering each chunk, indexed by the chunk's position in memory
    (a reverse scan enters from the right): the golden model runs chunk by
    chunk, each seeded with the state the last one returned."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    batch = G // K
    if reverse:
        u, delta, B, C = (torch.flip(t, dims=(1,)) for t in (u, delta, B, C))

    def unfold(t, width):       # [G, L, w] -> [batch, L, K, w]
        return t.reshape(batch, K, L, width).transpose(1, 2)

    args = (unfold(u, Dm).reshape(batch, L, K * Dm),
            unfold(delta, Dm).reshape(batch, L, K * Dm),
            A.reshape(K * Dm, N), unfold(B, N), unfold(C, N))
    kw = dict(D=D.reshape(-1), delta_bias=bias.reshape(-1),
              delta_softplus=softplus)
    if want_xsave:
        nT = -(-L // chunk)
        edges = [min(c * chunk, L) for c in range(nT + 1)]
        if reverse:     # the flipped sequence meets the ragged chunk first
            edges = [L - e for e in reversed(edges)]
        x = torch.zeros(batch, K * Dm, N, dtype=torch.float32,
                        device=u.device)
        ys, states = [], []
        for a, b in zip(edges[:-1], edges[1:]):
            states.append(x)
            uc, dc, Bc, Cc = (t[:, a:b] for t in
                              (args[0], args[1], args[3], args[4]))
            y_c, x = selective_scan_seq(uc, dc, args[2], Bc, Cc, **kw,
                                        return_last_state=True,
                                        initial_state=x)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        # [nT scan order, batch, K*Dm, N] -> [G, nT memory order, N, Dm]
        xsave = torch.stack(states[::-1] if reverse else states, dim=1)
        xsave = xsave.reshape(batch, nT, K, Dm, N).permute(0, 2, 1, 4, 3)
        xsave = xsave.reshape(G, nT, N, Dm)
    else:
        y = selective_scan_seq(*args, **kw)
    y = y.reshape(batch, L, K, Dm).transpose(1, 2).reshape(G, L, Dm)
    if reverse:
        y = torch.flip(y, dims=(1,))
    return (y, xsave.contiguous()) if want_xsave else y


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


def _fwd_kernel(u, delta, A, B, C, D, bias, y, xsave, reverse, softplus):
    """Launch csrc/selective_scan_fwd.cu on the current stream; raises if
    the launch fails.  ``xsave`` may be None (no saved states)."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             [u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
              None if xsave is None else xsave.data_ptr(),
              G, L, Dm, K, N, int(u.dtype == torch.bfloat16), int(reverse),
              int(softplus), stream])


def _launch_cuda(u, delta, A, B, C, D, bias, reverse, softplus,
                 want_xsave=False):
    """The kernel wrapper: checks, allocates y (and xsave), launches and
    counts the launch."""
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    N = A.shape[2]
    y = torch.empty_like(u)
    xsave = (torch.empty(G, -(-L // CHUNK), N, Dm, dtype=torch.float32,
                         device=u.device) if want_xsave else None)
    _fwd_kernel(u, delta, A, B, C, D, bias, y, xsave, reverse, softplus)
    scan_folded_fwd.launches += 1
    return (y, xsave) if want_xsave else y


def scan_folded_fwd(u, delta, A, B, C, D, bias, reverse: bool = False,
                    softplus: bool = True, impl: str = "auto"):
    """Folded selective-scan forward.

    ``impl``: ``"auto"`` takes the CUDA kernel for a CUDA tensor and the
    plain version for a CPU tensor; ``"cuda"`` launches the kernel or
    raises; ``"torch"`` runs the plain version on any device.  The kernel
    never falls back: a failed build or launch raises.  Parameters (A, D,
    bias) are cast to fp32 here, as the JAX entry does.

    With grad enabled and any input requiring grad, the call goes through
    ``ScanFolded`` (forward with saved states, backward kernel or plain
    backward by the same ``impl``); otherwise (eval, ``no_grad``,
    ``inference_mode``) only the forward runs, without saved states.
    """
    impl = resolve_impl(impl, u, "scan")
    A, D, bias = (t.float().contiguous() for t in (A, D, bias))
    args = (u, delta, A, B, C, D, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        from medical_image_classification_tpu_torch.kernels.selective_scan_bwd import (  # noqa: E501
            ScanFolded)
        return ScanFolded.apply(*args, reverse, softplus, impl)
    if impl == "torch":
        return scan_folded_fwd_ref(*args, reverse=reverse, softplus=softplus)
    return _launch_cuda(*args, reverse, softplus)


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_folded_fwd.launches = 0
