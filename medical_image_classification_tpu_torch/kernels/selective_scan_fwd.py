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

from medical_image_classification_tpu_torch.kernels import ops
from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    resolve_impl,
    via_op,
)
from medical_image_classification_tpu_torch.kernels.selective_scan import (
    selective_scan_seq,
)

_KERNEL = "selective_scan_fwd"
_MAX_N = 64
_DTYPES = (torch.float32, torch.bfloat16)
# Timesteps per chunk, shared by the forward and backward kernels (kChunk
# in csrc/selective_scan_common.cuh): the unit of their parallelism in time
# and the chunk of xsave.  The backward keeps a chunk's states in registers,
# 16 steps x 4 states a thread; xsave costs 4 B x N per channel per 16
# steps.  The TPU's _choose_tiles T was sized for VMEM and does not apply.
CHUNK = 16


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
    returned.  Returns y, then xsave, then the last state, as asked.
    Float64 operands (the exact reference) keep float64 throughout, and
    torch.autograd differentiates this function."""
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
    wide = torch.promote_types(u.dtype, torch.float32)   # float64 stays
    x = (torch.zeros(batch, K * Dm, N, dtype=wide, device=u.device)
         if init is None else _state_to_generic(init.to(wide), K))
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


def chunked_operands(u, delta, A, B, C, bias, softplus, chunk):
    """The folded scan's operands in fp32, cut into chunks of ``chunk``
    steps in memory order, as the two-level kernels walk them: dt, dt * u
    [G, nT, chunk, Dm, 1], B and C [G, nT, chunk, 1, N], A per sequence
    [G, 1, Dm, N].  The ragged last chunk is padded with dt = u = B = C = 0,
    the scan's identity step (a = 1, b = 0), so a padded chunk scanned from
    either end gives what the kernels' ragged walk gives."""
    f32 = torch.float32
    G, L, Dm = u.shape
    K, _, N = A.shape
    nT = -(-L // chunk)
    raw = delta.to(f32) + bias.to(f32).repeat(G // K, 1)[:, None, :]
    dt = F.softplus(raw) if softplus else raw

    def cut(t, width):          # [G, L, w] -> [G, nT, chunk, w], 0-padded
        t = F.pad(t.to(f32), (0, 0, 0, nT * chunk - L))
        return t.reshape(G, nT, chunk, width)

    dt = cut(dt, Dm)
    return dict(dt=dt[..., None], dtu=(dt * cut(u, Dm))[..., None],
                B=cut(B, N)[..., None, :], C=cut(C, N)[..., None, :],
                A=A.to(f32).repeat(G // K, 1, 1)[:, None])


def scan_folded_fwd_two_level_ref(u, delta, A, B, C, D, bias,
                                  reverse: bool = False,
                                  softplus: bool = True,
                                  want_xsave: bool = False,
                                  want_state: bool = False, init=None,
                                  chunk: int = CHUNK):
    """Plain PyTorch version of the two-level forward kernel's
    decomposition (csrc/selective_scan_fwd.cu), all chunks at once: (a)
    each chunk walks its steps from a zero state, leaving h_c and its sum
    of dt; (b) a carry pass over the chunks in scan order, seeded by
    ``init``: x_in[c + 1] = exp(A sum(dt_c)) x_in[c] + h_c, the last value
    the last state; (c) each chunk walks again from x_in[c] and emits y.
    Returns as ``scan_folded_fwd_ref`` (xsave is x_in, [G, nT, N, Dm] in
    memory order).  The tests hold it against the sequential twin; nothing
    on the card runs it."""
    G, L, Dm = u.shape
    N = A.shape[2]
    op = chunked_operands(u, delta, A, B, C, bias, softplus, chunk)
    nT = op["dt"].shape[1]
    steps = range(chunk - 1, -1, -1) if reverse else range(chunk)

    def walk(x, emit=None):     # one pass over every chunk, x [G, nT, Dm, N]
        for r in steps:
            x = torch.exp(op["dt"][:, :, r] * op["A"]) * x \
                + op["dtu"][:, :, r] * op["B"][:, :, r]
            if emit is not None:
                emit[:, :, r] = (x * op["C"][:, :, r]).sum(-1)
        return x

    h = walk(torch.zeros(G, nT, Dm, N, dtype=torch.float32, device=u.device))
    decay = torch.exp(op["dt"].sum(2) * op["A"])              # [G, nT, Dm, N]
    carry = (torch.zeros_like(h[:, 0]) if init is None
             else init.float().transpose(1, 2))
    x_in = torch.empty_like(h)
    for c in (range(nT - 1, -1, -1) if reverse else range(nT)):
        x_in[:, c] = carry
        carry = decay[:, c] * carry + h[:, c]
    yc = torch.empty(G, nT, chunk, Dm, dtype=torch.float32, device=u.device)
    walk(x_in, emit=yc)
    Dg = D.float().repeat(G // D.shape[0], 1)[:, None, :]
    y = (yc.reshape(G, nT * chunk, Dm)[:, :L] + u.float() * Dg).to(u.dtype)
    outs = (y,) + ((x_in.transpose(2, 3).contiguous(),) if want_xsave
                   else ()) + (
        (carry.transpose(1, 2).contiguous(),) if want_state else ())
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
    """Launch csrc/selective_scan_fwd.cu (its three passes) on the current
    stream; raises if the launch fails.  ``xsave``, ``init`` and ``last``
    may each be None: the kernel then takes a scratch xsave, and it always
    takes scratch for the chunks' sums of dt."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    nT = -(-L // CHUNK)
    f32 = dict(dtype=torch.float32, device=u.device)
    if xsave is None:
        xsave = torch.empty(G, nT, N, Dm, **f32)
    sdt = torch.empty(G, nT, Dm, **f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
             + [ctypes.c_void_p],
             [u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
              xsave.data_ptr(), _ptr(init), _ptr(last), sdt.data_ptr(),
              G, L, Dm, K, N, CHUNK, int(u.dtype == torch.bfloat16),
              int(reverse), int(softplus), stream])


def pass_info(N: int, dtype, backward: bool = False) -> dict:
    """What the card grants each pass of the scan kernel at d_state ``N``
    and operand type ``dtype``: {pass: (registers a thread, local-memory
    bytes a thread (spills), resident warps per SM)}, from
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor.
    Forward passes: chunk, carry, final; backward: local, carry, final,
    sum."""
    from medical_image_classification_tpu_torch.kernels import _build
    name = "selective_scan_bwd" if backward else _KERNEL
    passes = (("local", "carry", "final", "sum") if backward
              else ("chunk", "carry", "final"))
    lib = _build.library(name)
    fn = getattr(lib, f"{name}_pass_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (3 * len(passes)))()
    _build.raise_on_error(lib, name, fn(N, int(dtype == torch.bfloat16),
                                        ctypes.addressof(out)))
    return {p: tuple(out[3 * i:3 * i + 3]) for i, p in enumerate(passes)}


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


def op_forward(u, delta, A, B, C, D, bias, init, reverse, softplus,
               want_xsave, want_state, impl):
    """The body of ``ops.selective_scan_fwd``: the kernel (``impl``
    "cuda") or the plain version ("torch"); [y, xsave?, last?]."""
    kw = dict(want_xsave=want_xsave, want_state=want_state, init=init)
    if impl == "cuda":
        outs = _launch_cuda(u, delta, A, B, C, D, bias, reverse, softplus,
                            **kw)
    else:
        outs = scan_folded_fwd_ref(u, delta, A, B, C, D, bias,
                                   reverse=reverse, softplus=softplus, **kw)
    return list(outs) if isinstance(outs, tuple) else [outs]


def scan_folded_fwd(u, delta, A, B, C, D, bias, reverse: bool = False,
                    softplus: bool = True, impl: str = "auto",
                    want_state: bool = False, init=None,
                    allow_v1: bool = True):
    """Folded selective-scan forward: y, or (y, last) with ``want_state``.

    ``impl``: ``"auto"`` takes the CUDA kernel for a CUDA tensor and the
    plain version for a CPU tensor; ``"cuda"`` launches the kernel or
    raises; ``"torch"`` runs the plain version on any device.  The kernel
    never falls back: a failed build or launch raises.  Parameters (A, D,
    bias) and ``init`` are cast to fp32 here, as the JAX entry does; a
    float64 ``u`` with ``impl="torch"`` keeps float64 throughout (the plain
    version, differentiated by torch.autograd).

    With grad enabled and any input requiring grad, the call goes through
    ``ScanFolded`` (forward with saved states, backward kernel or plain
    backward by the same ``impl``; ``init`` gets its gradient); otherwise
    (eval, ``no_grad``, ``inference_mode``) only the forward runs, without
    saved states.

    Where the JAX folded entry takes its v1 kernels (``_choose_tiles``
    gives a chunk T with T % 8 != 0, which only a lowered
    ``selective_scan_v1._T_CAP`` reaches), so does this one, and the flags
    and ``reverse`` then raise ``ValueError``; ``allow_v1=False`` (the
    generic-layout entry, which the JAX package gates off v1) keeps the
    two-level kernels.
    """
    impl = resolve_impl(impl, u, "scan")
    if impl == "torch" and u.dtype == torch.float64:
        # the exact reference of a gradient check: the plain version keeps
        # float64 (the parameters and ``init`` too), under torch.autograd
        return scan_folded_fwd_ref(
            u, delta, A.double(), B, C, D.double(), bias.double(),
            reverse=reverse, softplus=softplus, want_state=want_state,
            init=None if init is None else init.double())
    A, D, bias = (t.float().contiguous() for t in (A, D, bias))
    if init is not None:
        init = init.float().contiguous()
    args = (u, delta, A, B, C, D, bias)
    T = None
    if allow_v1:
        from medical_image_classification_tpu_torch.kernels import (
            selective_scan_v1 as v1)
        T = v1.v1_chunk(u.shape[1], u.shape[2], A.shape[2])
        if T is not None:
            v1.check_v1_flags(reverse, softplus, want_state, init)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args + (init,)):
        from medical_image_classification_tpu_torch.kernels.selective_scan_bwd import (  # noqa: E501
            ScanFolded)
        return ScanFolded.apply(*args, reverse, softplus, impl, want_state,
                                init, T)
    if T is not None:
        return v1.scan_v1_fwd(*args, T, impl=impl)
    if not via_op(impl, u):
        return scan_folded_fwd_ref(*args, reverse=reverse, softplus=softplus,
                                   want_state=want_state, init=init)
    outs = ops.selective_scan_fwd(*args, init, reverse, softplus, False,
                                  want_state, impl)
    return tuple(outs) if want_state else outs[0]


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
                          want_state=return_last_state, init=init,
                          allow_v1=False)
    y, last = out if return_last_state else (out, None)
    y = y.reshape(batch, K, L, Dm).transpose(1, 2).reshape(batch, L, KD)
    if z is not None:
        y = (y.float() * F.silu(z.float())).to(y.dtype)
    if return_last_state:
        return y, _state_to_generic(last, K)
    return y
