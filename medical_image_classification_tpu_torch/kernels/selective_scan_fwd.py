"""Selective-scan forward in the folded layout: plain version, CUDA kernel
wrapper, and the dispatcher between them; and the generic-layout entry.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py``
``selective_scan_pallas_folded`` and the forward kernel behind it
(``selective_scan_pallas_v2.py::fwd_folded_v2``), with its state flags:
``want_state`` returns the state after the last step scanned and ``init``
seeds the state before the first, both [G, N, Dm] fp32.  Under autograd the
dispatcher goes through ``kernels/selective_scan_bwd.py::ScanFolded``, which
saves the forward's ``xsave`` (the fp32 state entering each chunk of
``CHUNK`` timesteps) for the backward.  ``selective_scan_generic`` is the
port of ``selective_scan_pallas``, the entry in ``selective_scan``'s
layout that the Mamba LM calls.

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
import torch.nn.functional as F

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


def _state_to_generic(s, K):
    """[G, N, Dm] -> [batch, K * Dm, N] (G = batch * K)."""
    G, N, Dm = s.shape
    return s.reshape(G // K, K, N, Dm).transpose(2, 3).reshape(
        G // K, K * Dm, N)


def _state_to_folded(s, K):
    """[batch, K * Dm, N] -> [batch * K, N, Dm]."""
    batch, KD, N = s.shape
    return s.reshape(batch, K, KD // K, N).transpose(2, 3).reshape(
        batch * K, N, KD // K)


def scan_folded_fwd_ref(u, delta, A, B, C, D, bias, reverse: bool = False,
                        softplus: bool = True, want_xsave: bool = False,
                        want_state: bool = False, init=None,
                        chunk: int = CHUNK):
    """Plain PyTorch version: unfold into the generic layout and run the
    sequential golden model (``reverse`` = flip, scan, flip back).

    ``init`` [G, N, Dm] seeds the state before the first step scanned (the
    rightmost for a reverse scan); ``want_state`` also returns the state
    after the last step scanned, [G, N, Dm] fp32.  ``want_xsave`` also
    returns xsave [G, ceil(L / chunk), N, Dm] fp32, the state entering each
    chunk, indexed by the chunk's position in memory (a reverse scan enters
    from the right, and its first chunk scanned holds ``init``): the golden
    model runs chunk by chunk, each seeded with the state the last one
    returned.  Returns y, then xsave, then the last state, as asked."""
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
    x = (torch.zeros(batch, K * Dm, N, dtype=torch.float32, device=u.device)
         if init is None else _state_to_generic(init.float(), K))
    if want_xsave:
        nT = -(-L // chunk)
        edges = [min(c * chunk, L) for c in range(nT + 1)]
        if reverse:     # the flipped sequence meets the ragged chunk first
            edges = [L - e for e in reversed(edges)]
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
        xsave = xsave.reshape(G, nT, N, Dm).contiguous()
    else:
        y, x = selective_scan_seq(*args, **kw, return_last_state=True,
                                  initial_state=x)
    y = y.reshape(batch, L, K, Dm).transpose(1, 2).reshape(G, L, Dm)
    if reverse:
        y = torch.flip(y, dims=(1,))
    outs = (y,) + ((xsave,) if want_xsave else ()) + (
        (_state_to_folded(x, K).contiguous(),) if want_state else ())
    return outs if len(outs) > 1 else y


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


def check_state(name, t, u, N):
    """A state operand (init, dlast): [G, N, Dm] fp32, contiguous, on u's
    device."""
    G, _, Dm = u.shape
    if t.device != u.device:
        raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if tuple(t.shape) != (G, N, Dm):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(G, N, Dm)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_kernel(u, delta, A, B, C, D, bias, y, xsave, reverse, softplus,
                init=None, last=None):
    """Launch csrc/selective_scan_fwd.cu on the current stream; raises if
    the launch fails.  ``xsave``, ``init`` and ``last`` may each be None."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
             + [ctypes.c_void_p],
             [u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
              _ptr(xsave), _ptr(init), _ptr(last),
              G, L, Dm, K, N, int(u.dtype == torch.bfloat16), int(reverse),
              int(softplus), stream])


def _launch_cuda(u, delta, A, B, C, D, bias, reverse, softplus,
                 want_xsave=False, want_state=False, init=None):
    """The kernel wrapper: checks, allocates y (and xsave, and the last
    state), launches and counts the launch.  Returns as
    ``scan_folded_fwd_ref``."""
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    N = A.shape[2]
    if init is not None:
        check_state("init", init, u, N)
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    xsave = (torch.empty(G, -(-L // CHUNK), N, Dm, **f32) if want_xsave
             else None)
    last = torch.empty(G, N, Dm, **f32) if want_state else None
    _fwd_kernel(u, delta, A, B, C, D, bias, y, xsave, reverse, softplus,
                init, last)
    scan_folded_fwd.launches += 1
    outs = tuple(t for t in (y, xsave, last) if t is not None)
    return outs if len(outs) > 1 else y


def scan_folded_fwd(u, delta, A, B, C, D, bias, reverse: bool = False,
                    softplus: bool = True, impl: str = "auto",
                    want_state: bool = False, init=None):
    """Folded selective-scan forward: y, or (y, last) with ``want_state``.

    ``impl``: ``"auto"`` takes the CUDA kernel for a CUDA tensor and the
    plain version for a CPU tensor; ``"cuda"`` launches the kernel or
    raises; ``"torch"`` runs the plain version on any device.  The kernel
    never falls back: a failed build or launch raises.  Parameters (A, D,
    bias) and ``init`` are cast to fp32 here, as the JAX entry does.

    With grad enabled and any input requiring grad, the call goes through
    ``ScanFolded`` (forward with saved states, backward kernel or plain
    backward by the same ``impl``; ``init`` gets its gradient); otherwise
    (eval, ``no_grad``, ``inference_mode``) only the forward runs, without
    saved states.
    """
    impl = resolve_impl(impl, u, "scan")
    A, D, bias = (t.float().contiguous() for t in (A, D, bias))
    if init is not None:
        init = init.float().contiguous()
    args = (u, delta, A, B, C, D, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args + (init,)):
        from medical_image_classification_tpu_torch.kernels.selective_scan_bwd import (  # noqa: E501
            ScanFolded)
        return ScanFolded.apply(*args, reverse, softplus, impl, want_state,
                                init)
    if impl == "torch":
        return scan_folded_fwd_ref(*args, reverse=reverse, softplus=softplus,
                                   want_state=want_state, init=init)
    return _launch_cuda(*args, reverse, softplus, want_state=want_state,
                        init=init)


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_folded_fwd.launches = 0


def selective_scan_generic(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                           delta_softplus=False, return_last_state=False,
                           initial_state=None, impl: str = "auto"):
    """``selective_scan``'s layout through the folded scan (port of
    ``selective_scan_pallas.py::selective_scan_pallas``).

    u, delta [batch, L, K * Dm]; A [K * Dm, N]; B, C [batch, L, N] (one
    group) or [batch, L, K, N]; D, delta_bias [K * Dm] or None; z [batch, L,
    K * Dm] or None; initial_state [batch, K * Dm, N] or None.  The groups
    fold into the sequence axis (G = batch * K), the kernel (or its plain
    version, by ``impl`` as in ``scan_folded_fwd``) scans, and the z-gate is
    applied outside it in fp32.  Returns y in u's dtype, and with
    ``return_last_state`` also the last state [batch, K * Dm, N] fp32.
    For K = 1 the folds are views: only operands that are not contiguous
    (the slices of B and C from x_proj) are copied."""
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    batch, L, KD = u.shape
    K, N = B.shape[2], B.shape[3]
    Dm = KD // K

    def fold(t, width):     # [batch, L, K * w] -> [batch * K, L, w]
        return t.reshape(batch, L, K, width).transpose(1, 2).reshape(
            batch * K, L, width).contiguous()

    zeros = lambda: torch.zeros(KD, dtype=torch.float32, device=u.device)
    Dk = (D if D is not None else zeros()).reshape(K, Dm)
    bk = (delta_bias if delta_bias is not None else zeros()).reshape(K, Dm)
    init = (None if initial_state is None
            else _state_to_folded(initial_state.float(), K))
    out = scan_folded_fwd(fold(u, Dm), fold(delta, Dm), A.reshape(K, Dm, N),
                          fold(B.reshape(batch, L, K * N), N),
                          fold(C.reshape(batch, L, K * N), N), Dk, bk,
                          softplus=delta_softplus, impl=impl,
                          want_state=return_last_state, init=init)
    y, last = out if return_last_state else (out, None)
    y = y.reshape(batch, K, L, Dm).transpose(1, 2).reshape(batch, L, KD)
    if z is not None:
        y = (y.float() * F.silu(z.float())).to(y.dtype)
    if return_last_state:
        return y, _state_to_generic(last, K)
    return y
