"""Selective-scan backward in the folded layout: plain version, CUDA kernel
wrapper, and the ``torch.autograd.Function`` that joins the forward and
backward.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py
::_make_scan_folded`` (the custom VJP, with the state flags: the last
state as an output, the initial state as an input) and of the backward
kernel behind it (``selective_scan_pallas_bwd_v2.py::bwd_folded_v2``, with
``dlast`` and ``want_dinit``).  Layout as in ``selective_scan_fwd.py``;
xsave [G, ceil(L / CHUNK), N, Dm] fp32 is the state entering each chunk, as
the forward saved it (the first chunk scanned holds the initial state).

Gradients: du and dΔ in u's dtype, dB and dC in B's dtype (each summed over
channels in fp32 and rounded once), dA [K, Dm, N], dD and dbias [K, Dm] in
fp32, summed over the batch from per-sequence partials; with
``want_dinit`` also dinit [G, N, Dm] fp32.
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
from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    CHUNK,
    _check_cuda_args,
    chunked_operands,
    _ptr,
    check_state,
    scan_folded_fwd_ref,
)

_KERNEL = "selective_scan_bwd"
_LANES = 32          # channels per block of the kernel (dB/dC partials)
_GROUP = 4           # chunks per block of its last pass (kGroup in csrc/)


def _sum_partials(u, A, dA_part, dD_part, dbias_part):
    """Per-sequence parameter partials -> sums over the batch (sequence g
    belongs to parameter group g % K), as ``bwd_folded_v2:398-401``."""
    G, _, Dm = u.shape
    K, _, N = A.shape
    batch = G // K
    dA = dA_part.reshape(batch, K, N, Dm).sum(0).transpose(1, 2)
    dD = dD_part.reshape(batch, K, Dm).sum(0)
    dbias = dbias_part.reshape(batch, K, Dm).sum(0)
    return dA, dD, dbias


def scan_folded_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy,
                        reverse: bool = False, softplus: bool = True,
                        dlast=None, want_dinit: bool = False,
                        chunk: int = CHUNK):
    """Plain PyTorch version of the backward kernel: the same chunk walk,
    the same xsave, the same gradient formulas, vectorised over (G, Dm, N)
    and looping over t.  ``dlast`` [G, N, Dm], the cotangent of the last
    state, seeds the adjoint's carry; ``want_dinit`` also returns the carry
    after the first step scanned, the initial state's cotangent [G, N, Dm]
    fp32.  Returns (du, ddelta, dA, dB, dC, dD, dbias[, dinit])."""
    f32 = torch.float32
    G, L, Dm = u.shape
    K, _, N = A.shape
    uf, dyf = u.to(f32), dy.to(f32)
    Bf, Cf = B.to(f32), C.to(f32)
    Ag = A.to(f32).repeat(G // K, 1, 1)                    # [G, Dm, N]
    raw = delta.to(f32) + bias.to(f32).repeat(G // K, 1)[:, None, :]
    dt = F.softplus(raw) if softplus else raw              # [G, L, Dm]
    sig = torch.sigmoid(raw) if softplus else torch.ones_like(raw)
    dtu = dt * uf

    du = torch.empty(G, L, Dm, dtype=f32, device=u.device)
    ddelta = torch.empty_like(du)
    dB = torch.empty(G, L, N, dtype=f32, device=u.device)
    dC = torch.empty_like(dB)
    dA_part = torch.zeros(G, Dm, N, dtype=f32, device=u.device)
    carry = (torch.zeros(G, Dm, N, dtype=f32, device=u.device)  # a_t g_t
             if dlast is None else dlast.to(f32).transpose(1, 2))
    nT = -(-L // chunk)
    for ci in (range(nT) if reverse else range(nT - 1, -1, -1)):
        rows = range(ci * chunk, min((ci + 1) * chunk, L))
        scan_rows = rows[::-1] if reverse else rows
        # recompute the chunk's states from its incoming state
        x = xsave[:, ci].to(f32).transpose(1, 2)          # [G, Dm, N]
        xs = {}
        for t in scan_rows:
            x = torch.exp(dt[:, t, :, None] * Ag) * x + \
                dtu[:, t, :, None] * Bf[:, t, None, :]
            xs[t] = x
        # the adjoint, against the scan direction
        for t in reversed(scan_rows):
            g = Cf[:, t, None, :] * dyf[:, t, :, None] + carry
            xa = xs[t] - dtu[:, t, :, None] * Bf[:, t, None, :]  # a_t x_prev
            gB = (g * Bf[:, t, None, :]).sum(-1)            # [G, Dm]
            du[:, t] = dt[:, t] * gB + D.to(f32).repeat(G // K, 1) * dyf[:, t]
            ddelta[:, t] = sig[:, t] * ((g * xa * Ag).sum(-1)
                                        + uf[:, t] * gB)
            dB[:, t] = (g * dtu[:, t, :, None]).sum(1)
            dC[:, t] = (xs[t] * dyf[:, t, :, None]).sum(1)
            dA_part += g * xa * dt[:, t, :, None]
            carry = torch.exp(dt[:, t, :, None] * Ag) * g
    dA, dD, dbias = _sum_partials(u, A, dA_part.transpose(1, 2),
                                  (dyf * uf).sum(1), ddelta.sum(1))
    grads = (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB.to(B.dtype),
             dC.to(C.dtype), dD, dbias)
    return grads + ((carry.transpose(1, 2).contiguous(),) if want_dinit
                    else ())


def scan_folded_bwd_two_level_ref(u, delta, A, B, C, D, bias, xsave, dy,
                                  reverse: bool = False,
                                  softplus: bool = True, dlast=None,
                                  want_dinit: bool = False,
                                  chunk: int = CHUNK):
    """Plain PyTorch version of the two-level backward kernel's
    decomposition (csrc/selective_scan_bwd.cu), all chunks at once: (a)
    each chunk walks its adjoint from a zero carry (g = C dy + a g_next,
    no state needed), leaving h_c = a_first g_first and its sum of dt; (b)
    a carry pass over the chunks in adjoint order, seeded by ``dlast``:
    q_prev = exp(A sum(dt_c)) q_c + h_c, its end dinit; (c) each chunk
    recomputes its states from ``xsave`` and walks its adjoint from q_c,
    emitting the gradients.  Returns as ``scan_folded_bwd_ref``.  The tests
    hold it against the sequential twin; nothing on the card runs it."""
    f32 = torch.float32
    G, L, Dm = u.shape
    K, _, N = A.shape
    op = chunked_operands(u, delta, A, B, C, bias, softplus, chunk)
    nT = op["dt"].shape[1]
    pad = lambda t: F.pad(t.to(f32), (0, 0, 0, nT * chunk - L)).reshape(
        G, nT, chunk, -1)[..., None]
    dyc, uc = pad(dy), pad(u)                         # [G, nT, chunk, Dm, 1]
    raw = delta.to(f32) + bias.to(f32).repeat(G // K, 1)[:, None, :]
    sig = pad(torch.sigmoid(raw) if softplus else torch.ones_like(raw))
    a = torch.exp(op["dt"] * op["A"][:, :, None])     # [G, nT, chunk, Dm, N]
    steps = range(chunk - 1, -1, -1) if reverse else range(chunk)

    gc = torch.zeros(G, nT, Dm, N, dtype=f32, device=u.device)
    for r in reversed(steps):                         # (a), adjoint order
        gc = a[:, :, r] * (op["C"][:, :, r] * dyc[:, :, r] + gc)
    decay = torch.exp(op["dt"].sum(2) * op["A"])
    carry = (torch.zeros_like(gc[:, 0]) if dlast is None
             else dlast.to(f32).transpose(1, 2))
    q = torch.empty_like(gc)
    for c in (range(nT) if reverse else range(nT - 1, -1, -1)):   # (b)
        q[:, c] = carry
        carry = decay[:, c] * carry + gc[:, c]

    x = xsave.to(f32).transpose(2, 3)                 # (c): [G, nT, Dm, N]
    xs = {}
    for r in steps:
        x = a[:, :, r] * x + op["dtu"][:, :, r] * op["B"][:, :, r]
        xs[r] = x
    du = torch.empty(G, nT, chunk, Dm, dtype=f32, device=u.device)
    ddelta, dB, dC = torch.empty_like(du), [None] * chunk, [None] * chunk
    dA = torch.zeros(G, Dm, N, dtype=f32, device=u.device)
    gc = q
    for r in reversed(steps):
        dtu, b = op["dtu"][:, :, r], op["B"][:, :, r]
        g = op["C"][:, :, r] * dyc[:, :, r] + gc
        xa = xs[r] - dtu * b                          # a_t x_prev
        gB = (g * b).sum(-1)
        du[:, :, r] = op["dt"][:, :, r, :, 0] * gB + \
            D.to(f32).repeat(G // K, 1)[:, None] * dyc[:, :, r, :, 0]
        ddelta[:, :, r] = sig[:, :, r, :, 0] * (
            (g * xa * op["A"]).sum(-1) + uc[:, :, r, :, 0] * gB)
        dB[r] = (g * dtu).sum(2)                      # [G, nT, N]
        dC[r] = (xs[r] * dyc[:, :, r]).sum(2)
        dA += (g * xa * op["dt"][:, :, r]).sum(1)
        gc = a[:, :, r] * g
    rows = lambda t: t.reshape(G, nT * chunk, -1)[:, :L]
    du, ddelta = rows(du), rows(ddelta)
    dB, dC = (rows(torch.stack(t, dim=2)) for t in (dB, dC))
    dA, dD, dbias = _sum_partials(u, A, dA.transpose(1, 2),
                                  (dy.to(f32) * u.to(f32)).sum(1),
                                  ddelta.sum(1))
    grads = (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB.to(B.dtype),
             dC.to(C.dtype), dD, dbias)
    return grads + ((carry.transpose(1, 2).contiguous(),) if want_dinit
                    else ())


def _check_bwd_args(u, delta, A, B, C, D, bias, xsave, dy):
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    N = A.shape[2]
    want = (G, -(-L // CHUNK), N, Dm)
    for name, t, shape, dtype in (("xsave", xsave, want, torch.float32),
                                  ("dy", dy, (G, L, Dm), u.dtype)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bwd_kernel(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part,
                dC_part, dA_part, dD_part, dbias_part, reverse, softplus,
                dlast=None, dinit=None):
    """Launch csrc/selective_scan_bwd.cu (its four passes) on the current
    stream with the scratch it needs; raises if the launch fails.
    ``dlast`` and ``dinit`` may each be None."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    nT = -(-L // CHUNK)
    # chunk carries, chunk sums of dt, per-block parameter partials
    floats = G * nT * (N + 1) * Dm + G * -(-nT // _GROUP) * (N + 2) * Dm
    scratch = torch.empty(floats, dtype=torch.float32, device=u.device)
    ptrs = [_ptr(t) for t in (u, delta, A, B, C, D, bias, xsave, dy, dlast,
                              du, ddelta, dB_part, dC_part, dA_part, dD_part,
                              dbias_part, dinit, scratch)]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        call(_KERNEL, [ctypes.c_void_p] * 19 + [ctypes.c_longlong]
             + [ctypes.c_int] * 9 + [ctypes.c_void_p],
             ptrs + [floats, G, L, Dm, K, N, CHUNK,
                     int(u.dtype == torch.bfloat16), int(reverse),
                     int(softplus), stream])


def _launch_cuda(u, delta, A, B, C, D, bias, xsave, dy, reverse, softplus,
                 dlast=None, want_dinit=False):
    """The kernel wrapper: checks, allocates the outputs and the partials,
    launches, counts the launch, and sums the partials.  Returns as
    ``scan_folded_bwd_ref``."""
    _check_bwd_args(u, delta, A, B, C, D, bias, xsave, dy)
    G, L, Dm = u.shape
    N = A.shape[2]
    if dlast is not None:
        check_state("dlast", dlast, u, N)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dB_part = torch.empty(-(-Dm // _LANES), G, L, N, **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty(G, N, Dm, **f32)
    dD_part = torch.empty(G, Dm, **f32)
    dbias_part = torch.empty(G, Dm, **f32)
    dinit = torch.empty(G, N, Dm, **f32) if want_dinit else None
    _bwd_kernel(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part,
                dC_part, dA_part, dD_part, dbias_part, reverse, softplus,
                dlast, dinit)
    scan_folded_bwd.launches += 1
    dA, dD, dbias = _sum_partials(u, A, dA_part, dD_part, dbias_part)
    grads = (du, ddelta, dA, dB_part.sum(0).to(B.dtype),
             dC_part.sum(0).to(C.dtype), dD, dbias)
    return grads + ((dinit,) if want_dinit else ())


def scan_folded_bwd(u, delta, A, B, C, D, bias, xsave, dy,
                    reverse: bool = False, softplus: bool = True,
                    impl: str = "auto", dlast=None, want_dinit: bool = False):
    """Folded selective-scan backward: (du, ddelta, dA, dB, dC, dD, dbias),
    and dinit with ``want_dinit``; ``dlast`` seeds the adjoint.

    ``impl`` as in ``scan_folded_fwd``: the CUDA kernel for CUDA tensors
    ("auto"/"cuda", which raises rather than fall back) or the plain
    version ("torch", or "auto" on the CPU)."""
    impl = resolve_impl(impl, u, "scan")
    if not via_op(impl, u):
        return scan_folded_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy,
                                   reverse=reverse, softplus=softplus,
                                   dlast=dlast, want_dinit=want_dinit)
    return tuple(ops.selective_scan_bwd(u, delta, A, B, C, D, bias, xsave,
                                        dy, dlast, reverse, softplus,
                                        want_dinit, impl))


def op_backward(u, delta, A, B, C, D, bias, xsave, dy, dlast, reverse,
                softplus, want_dinit, impl):
    """The body of ``ops.selective_scan_bwd``: the kernel (``impl``
    "cuda") or the plain version ("torch"); the cotangents in their
    primals' dtypes, then dinit."""
    run = _launch_cuda if impl == "cuda" else scan_folded_bwd_ref
    grads = run(u, delta, A, B, C, D, bias, xsave, dy, reverse, softplus,
                dlast=dlast, want_dinit=want_dinit)
    primals = (u, delta, A, B, C, D, bias)
    return [g.to(p.dtype) for g, p in zip(grads, primals)] + list(grads[7:])


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_folded_bwd.launches = 0


class ScanFolded(torch.autograd.Function):
    """The folded scan under autograd (``selective_scan_pallas.py:276-353``).

    ``apply(u, delta, A, B, C, D, bias, reverse, softplus, impl[,
    want_state, init, T])``: y, or (y, last) with ``want_state``; ``init``
    (None or [G, N, Dm] fp32) is a primal with its own gradient.  The
    forward saves (u, delta, A, B, C, D, bias, xsave), xsave holding
    ``init`` as the first scanned chunk's state; the backward runs the
    backward kernel (``impl="cuda"``) or the plain backward
    (``impl="torch"``), seeded with the last state's cotangent, and casts
    each gradient to its input's dtype, as ``_cast_like`` does.  A, D and
    bias arrive in fp32 (the dispatcher casts them).  With a chunk ``T``
    (``selective_scan_v1.v1_chunk``; no flags) the pair is the v1 forward
    and backward instead, xsave [G, ceil(L / T), N, Dm]."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, bias, reverse, softplus, impl,
                want_state=False, init=None, T=None):
        if T is not None:
            from medical_image_classification_tpu_torch.kernels import (
                selective_scan_v1 as v1)
            outs = v1.scan_v1_fwd(u, delta, A, B, C, D, bias, T,
                                  want_xsave=True, impl=impl)
        elif via_op(impl, u):
            outs = ops.selective_scan_fwd(u, delta, A, B, C, D, bias, init,
                                          reverse, softplus, True, want_state,
                                          impl)
        else:
            outs = scan_folded_fwd_ref(u, delta, A, B, C, D, bias, reverse,
                                       softplus, want_xsave=True,
                                       want_state=want_state, init=init)
        ctx.save_for_backward(u, delta, A, B, C, D, bias, outs[1])
        ctx.flags = (reverse, softplus, impl, want_state, init is not None, T)
        return (outs[0], outs[2]) if want_state else outs[0]

    @staticmethod
    def backward(ctx, dy, dlast=None):
        saved = ctx.saved_tensors      # unpacked once (activation checkpoint)
        reverse, softplus, impl, want_state, has_init, T = ctx.flags
        # the cotangent of a column-layout direction arrives transposed
        # (ops/ss2d.py un_col); the kernel reads [G, L, Dm] rows
        if T is not None:
            from medical_image_classification_tpu_torch.kernels import (
                selective_scan_v1 as v1)
            grads = v1.scan_v1_bwd(*saved, dy.contiguous(), T, impl=impl)
            return tuple(g.to(p.dtype) for g, p in zip(grads, saved)) + (
                None,) * 6
        if dlast is not None:
            dlast = dlast.float().contiguous()
        if via_op(impl, dy):
            grads = ops.selective_scan_bwd(*saved, dy.contiguous(), dlast,
                                           reverse, softplus, has_init, impl)
        else:
            grads = scan_folded_bwd_ref(*saved, dy.contiguous(), reverse,
                                        softplus, dlast=dlast,
                                        want_dinit=has_init)
        return tuple(g.to(p.dtype) for g, p in zip(grads[:7], saved)) + (
            None, None, None, None, grads[7] if has_init else None, None)
