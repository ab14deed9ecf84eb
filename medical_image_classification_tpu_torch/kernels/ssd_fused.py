"""The single-layout fused SSD scan: the gate, the plain forward and
backward, the CUDA kernels' wrappers and dispatchers, and the autograd
Function that joins them; and the plain chunk walk that this and the
four-direction module (``kernels/ssd_fused_dirs.py``) share.

Port of ``medical_image_classification_tpu/kernels/ssd_fused_pallas.py``
(``ssd_fused_supported``, the forward body ``_fwd_kernel``, the backward
body ``_bwd_kernel`` and the custom VJP ``ssd_fused``).  Kernels:
``csrc/ssd_fused_fwd.cu`` and ``csrc/ssd_fused_bwd.cu`` (the chunk walk of
``csrc/ssd_walk_{fwd,bwd}.cuh`` over the single layout).

Layouts (one B/C group, ref_flat):
  Cc, Bc : [B, nc, l, N]     the operand dtype (fp32 or bf16)
  acum   : [B, nc, H, l]     fp32 inclusive cumsum of dt A within the chunk
  dte    : [B, nc, H, l]     fp32 exp(acum[..., -1:] - acum)
  cdec   : [B, nc, H]        fp32 exp(acum[..., -1])
  dtp    : [B, nc, H, l]     fp32 softplus(dt + bias), the step
  x, y   : [B, nc, l, H P]   flat and l-major (a view of [B, L, H, P])
  Ssave  : [B, nc, H, P, N]  the state entering each chunk, operand dtype

Per batch and head, the chunks in order from a zero state S [P, N]:
  y   = rnd(M dtx) + (C rnd(S)^T) exp(acum),   M = rnd(C B^T * decay),
  dtx = rnd(x dtp),   S <- cdec S + rnd(dtx dte)^T B,
every product summed in fp32 over operand-type values and rnd() rounding
to the operand dtype where the TPU body's ``.astype(mm_dtype)`` rounds
(``M``, ``dtx``, ``Sin``, ``dtx_d``; backward also ``dYoff`` and the
head-summed ``dscores``), so a bf16 comparison means something.  dte and
cdec are primal inputs with their own cotangents: autograd chains them to
acum outside the kernel, as the JAX VJP does.
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels import ops
from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    resolve_impl,
    via_op,
)

_FWD_KERNEL = "ssd_fused_fwd"
_BWD_KERNEL = "ssd_fused_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# The chunk window of the gate; module constants so that tests can widen
# it to small shapes, as the JAX package's tests patch its ``_MIN_L``.
_MIN_L = 196
_MAX_L = 256
# shape limits of the CUDA kernels: their warps take P and N in whole
# tiles of PT, and the forward's output pass and the backward's chunk pass
# keep a chunk's MAX_L rows
PT = 32
MAX_L = 256
MAX_N = 512
# the walks' tiles of rows, of P and of N (csrc/ssd_walk_tiles.cuh kT),
# which size the backward's per-tile partials, and the passes of each
BWD_TILE = 64
FWD_PASSES = ("prep", "gram", "state", "out")
BWD_PASSES = ("prep", "gram", "intra", "state", "chunk", "flush")


def ssd_fused_supported(l: int, N: int, P: int, G: int, nc: int,
                        card: bool = False, batch: int = 1,
                        dtype: torch.dtype = torch.float32) -> bool:
    """The shape terms of the JAX gate (``ssd_fused_pallas.py:113-136``):
    one group, at least two chunks, l inside the window and a multiple of
    4, N % 128 and P % 8.  Without its TPU-only terms: the backend, the
    VMEM fit (``_vmem_ok``, ``_heads_per_group``: the only use of its head
    count H) and "fp32 stays on XLA" (a TPU measurement); fp32 takes the
    kernel here, which is the same function and lets the card's fp32
    checks cover it.
    ``card``: the operands lie on the GPU, where the CUDA kernels also need
    P a multiple of ``PT``, N <= ``MAX_N``, l <= ``MAX_L``, batch x nc <=
    65535 and a float32 or bfloat16 dtype (what ``_check_cuda_args``
    refuses); elsewhere the plain version takes any of these shapes."""
    if not (G == 1 and nc >= 2 and _MIN_L <= l <= _MAX_L and l % 4 == 0
            and N % 128 == 0 and P % 8 == 0):
        return False
    return not card or (P % PT == 0 and N <= MAX_N and l <= MAX_L
                        and batch * nc <= 65535 and dtype in _DTYPES)


def _decay(a, causal):
    """exp(a_i - a_j) for i >= j, else 0: [..., l] -> [..., l, l].  The
    masked entries are zeroed before the exp too, so that neither the
    value nor its autograd meets an overflow there."""
    seg = (a[..., :, None] - a[..., None, :]).masked_fill(~causal, 0.0)
    return torch.where(causal, torch.exp(seg), 0.0)


def walk_fwd_ref(x, Bf, Cf, acum, dte, cdec, dtp, mm, Dsk=None,
                 want_save: bool = False):
    """The TPU forward body's chunk walk, vectorised over batch and heads.
    x [B, nc, H, l, P] and Bf, Cf [B, nc, l, N] in fp32 (exact values of the
    operand dtype ``mm``), in scan-position order; ``Dsk`` [H] adds the D
    skip x D.  Returns y [B, nc, H, l, P] in ``mm`` and Ssave [B, nc, H, P,
    N] in ``mm`` (None without ``want_save``)."""
    B, nc, H, l, P = x.shape
    rnd = lambda t: t.to(mm).float()
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    S = torch.zeros(B, H, P, Bf.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys, saves = [], []
    for c in range(nc):
        Bc, Cc = Bf[:, c], Cf[:, c]                         # [B, l, N]
        sc = Cc @ Bc.transpose(1, 2)                         # [B, l, l]
        a = acum[:, c]                                       # [B, H, l]
        M = rnd(sc[:, None] * _decay(a, causal))             # [B, H, l, l]
        xc = x[:, c]                                         # [B, H, l, P]
        dtx = rnd(xc * dtp[:, c, :, :, None])
        if want_save:
            saves.append(S.to(mm))
        Yoff = Cc[:, None] @ rnd(S).transpose(-1, -2)        # [B, H, l, P]
        yc = M @ dtx + Yoff * torch.exp(a)[..., None]
        if Dsk is not None:
            yc = yc + xc * Dsk[:, None, None]
        ys.append(yc.to(mm))
        dtx_d = rnd(dtx * dte[:, c, :, :, None])
        S = cdec[:, c, :, None, None] * S + dtx_d.transpose(-1, -2) @ \
            Bc[:, None]
    return torch.stack(ys, dim=1), \
        torch.stack(saves, dim=1) if want_save else None


def walk_fwd_chunked_ref(x, Bf, Cf, acum, dte, cdec, dtp, mm, Dsk=None,
                         want_save: bool = False):
    """``walk_fwd_ref`` in the order of the CUDA kernels' decomposition
    (``csrc/ssd_walk_fwd.cuh``): every chunk's state increment Delta =
    rnd(dtx dte)^T B at once, then the fp32 carry S(c+1) = cdec(c) S(c) +
    Delta(c) (the only sequential part) keeping rnd(S(c)), then every
    chunk's y at once.  Same arguments and results as ``walk_fwd_ref``."""
    B, nc, H, l, P = x.shape
    rnd = lambda t: t.to(mm).float()
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    dtx = rnd(x * dtp[..., None])                        # [B, nc, H, l, P]
    delta = rnd(dtx * dte[..., None]).transpose(-1, -2) @ Bf[:, :, None]
    S = torch.zeros_like(delta[:, 0])                    # [B, H, P, N]
    Sin = torch.empty(delta.shape, dtype=mm, device=x.device)
    for c in range(nc):
        Sin[:, c] = S.to(mm)
        S = cdec[:, c, :, None, None] * S + delta[:, c]
    sc = Cf @ Bf.transpose(-1, -2)                       # [B, nc, l, l]
    M = rnd(sc[:, :, None] * _decay(acum, causal))       # [B, nc, H, l, l]
    Yoff = Cf[:, :, None] @ Sin.float().transpose(-1, -2)
    y = M @ dtx + Yoff * torch.exp(acum)[..., None]
    if Dsk is not None:
        y = y + x * Dsk[:, None, None]
    return y.to(mm), Sin if want_save else None


def walk_bwd_ref(x, Bf, Cf, acum, dte, cdec, dtp, Ssave, dy, mm, Dsk=None):
    """The TPU backward body, formula by formula: the chunks walked in
    reverse from the saved boundary states.  x, Bf, Cf as in
    ``walk_fwd_ref``; dy [B, nc, H, l, P] fp32 (exact ``mm`` values).
    Returns dx [B, nc, H, l, P] in ``mm``; dacum, ddte, ddtp like acum;
    dcdec like cdec; dD [B, nc, H] (None without ``Dsk``); dB, dC
    [B, nc, l, N] in ``mm`` (their head sums, plus the head-summed dscores'
    products rounded once)."""
    B, nc, H, l, P = x.shape
    f32 = torch.float32
    rnd = lambda t: t.to(mm).float()
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    dS = torch.zeros(B, H, P, Bf.shape[-1], dtype=f32, device=x.device)
    dx = torch.empty(B, nc, H, l, P, dtype=mm, device=x.device)
    dacum, ddte, ddtp = (torch.empty_like(acum) for _ in range(3))
    dcdec = torch.empty_like(cdec)
    dD = torch.empty_like(cdec) if Dsk is not None else None
    dB = torch.empty(Bf.shape, dtype=mm, device=x.device)
    dC = torch.empty_like(dB)
    for rc in range(nc - 1, -1, -1):
        Bc, Cc = Bf[:, rc], Cf[:, rc]
        sc = Cc @ Bc.transpose(1, 2)
        a = acum[:, rc]
        E = _decay(a, causal)
        M = sc[:, None] * E                                  # fp32
        xf = x[:, rc]
        dtx = rnd(xf * dtp[:, rc, :, :, None])
        dy_ = dy[:, rc]
        Sin = Ssave[:, rc].float()                           # [B, H, P, N]
        dSout = dS
        # Y_diag adjoints
        ddtx_diag = rnd(M).transpose(-1, -2) @ dy_
        dM = dy_ @ dtx.transpose(-1, -2)
        dscores = (dM * E).sum(1)                            # [B, l, l]
        G = dM * M
        dacum_h = G.sum(-1) - G.sum(-2)
        # Y_off = (C Sin^T) exp(acum) adjoints
        eA = torch.exp(a)[..., None]
        Yoff = Cc[:, None] @ Sin.transpose(-1, -2)
        dYoff = rnd(dy_ * eA)
        dacum[:, rc] = dacum_h + (dy_ * Yoff * eA).sum(-1)
        dC_acc = torch.einsum("bhlp,bhpn->bln", dYoff, Sin)
        dSin = dYoff.transpose(-1, -2) @ Cc[:, None]
        # state recurrence adjoints
        dte_ = dte[:, rc, :, :, None]
        t = Bc[:, None] @ rnd(dSout).transpose(-1, -2)       # [B, H, l, P]
        ddtx = ddtx_diag + t * dte_
        dxv = ddtx * dtp[:, rc, :, :, None]
        if Dsk is not None:
            dD[:, rc] = (dy_ * xf).sum((-1, -2))
            dxv = dxv + dy_ * Dsk[:, None, None]
        dx[:, rc] = dxv.to(mm)
        ddtp[:, rc] = (ddtx * xf).sum(-1)
        dB_acc = torch.einsum("bhlp,bhpn->bln", rnd(dtx * dte_), rnd(dSout))
        ddte[:, rc] = (t * dtx).sum(-1)
        dcdec[:, rc] = (dSout * Sin).sum((-1, -2))
        dS = cdec[:, rc, :, None, None] * dSout + dSin
        ds = rnd(dscores)
        dC[:, rc] = dC_acc + ds @ Bc
        dB[:, rc] = dB_acc + ds.transpose(1, 2) @ Cc
    return dx, dacum, ddte, dcdec, ddtp, dD, dB, dC


def walk_bwd_chunked_ref(x, Bf, Cf, acum, dte, cdec, dtp, Ssave, dy, mm,
                         Dsk=None):
    """``walk_bwd_ref`` in the order of the CUDA kernels' decomposition
    (``csrc/ssd_walk_bwd.cuh``): every chunk's state cotangent input dSin =
    rnd(dy e^a)^T C at once, then the state-passing recurrence dSout(c-1) =
    cdec(c) dSout(c) + dSin(c) (the only sequential part), then every
    chunk-local product at once.  Same arguments and results as
    ``walk_bwd_ref``."""
    B, nc, H, l, P = x.shape
    rnd = lambda t: t.to(mm).float()
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    Ssave = Ssave.float()
    C4, B4 = Cf[:, :, None], Bf[:, :, None]             # [B, nc, 1, l, N]
    eA = torch.exp(acum)[..., None]                      # [B, nc, H, l, 1]
    dYoff = rnd(dy * eA)
    dSin = dYoff.transpose(-1, -2) @ C4                  # [B, nc, H, P, N]
    dS = torch.zeros_like(dSin[:, 0])
    dSout = torch.empty_like(dSin)
    for c in range(nc - 1, -1, -1):
        dSout[:, c] = dS
        dS = cdec[:, c, :, None, None] * dS + dSin[:, c]
    dso = rnd(dSout)
    dcdec = (dSout * Ssave).sum((-1, -2))
    sc = Cf @ Bf.transpose(-1, -2)                       # [B, nc, l, l]
    E = _decay(acum, causal)                             # [B, nc, H, l, l]
    M = sc[:, :, None] * E
    dtx = rnd(x * dtp[..., None])
    ddtx_diag = rnd(M).transpose(-1, -2) @ dy
    dM = dy @ dtx.transpose(-1, -2)
    G = dM * M
    Yoff = C4 @ Ssave.transpose(-1, -2)                  # [B, nc, H, l, P]
    dacum = G.sum(-1) - G.sum(-2) + (dy * Yoff * eA).sum(-1)
    t = B4 @ dso.transpose(-1, -2)
    dte_ = dte[..., None]
    ddtx = ddtx_diag + t * dte_
    dxv = ddtx * dtp[..., None]
    dD = None
    if Dsk is not None:
        dD = (dy * x).sum((-1, -2))
        dxv = dxv + dy * Dsk[:, None, None]
    ds = rnd((dM * E).sum(2))                            # [B, nc, l, l]
    dC = (torch.einsum("bchlp,bchpn->bcln", dYoff, Ssave) + ds @ Bf).to(mm)
    dB = (torch.einsum("bchlp,bchpn->bcln", rnd(dtx * dte_), dso)
          + ds.transpose(-1, -2) @ Cf).to(mm)
    return (dxv.to(mm), dacum, (t * dtx).sum(-1), dcdec,
            (ddtx * x).sum(-1), dD, dB, dC)


def _heads(t, H):
    """Flat l-major [B, nc, l, H P] -> fp32 [B, nc, H, l, P]."""
    B, nc, l, HP = t.shape
    return t.reshape(B, nc, l, H, HP // H).transpose(2, 3).float()


def _flat(t):
    """[B, nc, H, l, P] -> flat l-major [B, nc, l, H P]."""
    B, nc, H, l, P = t.shape
    return t.transpose(2, 3).reshape(B, nc, l, H * P)


def ssd_fused_fwd_ref(Cc, Bc, acum, dte, cdec, dtp, x,
                      want_save: bool = False):
    """Plain PyTorch version of the forward kernel.  Returns y in x's
    dtype, and Ssave when ``want_save``."""
    H = acum.shape[2]
    y, Ssave = walk_fwd_ref(_heads(x, H), Bc.float(), Cc.float(), acum, dte,
                            cdec, dtp, Cc.dtype, want_save=want_save)
    y = _flat(y).to(x.dtype)
    return (y, Ssave) if want_save else y


def ssd_fused_bwd_ref(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy):
    """Plain PyTorch version of the backward kernel: (dC, dB, dacum, ddte,
    dcdec, ddtp, dx), the cotangents of the forward's operands, in the
    order of ``_vjp_bwd``."""
    H = acum.shape[2]
    dx, dacum, ddte, dcdec, ddtp, _, dB, dC = walk_bwd_ref(
        _heads(x, H), Bc.float(), Cc.float(), acum, dte, cdec, dtp, Ssave,
        _heads(dy.to(Cc.dtype), H), Cc.dtype)
    return dC, dB, dacum, ddte, dcdec, ddtp, _flat(dx).to(x.dtype)


# --------------------------------------------------------------------------
# CUDA kernels


def _check_cuda_args(Cc, Bc, acum, dte, cdec, dtp, x, Ssave=None, dy=None):
    """Raise on operands the kernels do not take (before any launch)."""
    if Cc.dim() != 4 or acum.dim() != 4 or x.dim() != 4:
        raise ValueError(f"Cc must be [B, nc, l, N], acum [B, nc, H, l] and "
                         f"x [B, nc, l, H P], got {tuple(Cc.shape)}, "
                         f"{tuple(acum.shape)} and {tuple(x.shape)}")
    if Cc.dtype not in _DTYPES:
        raise TypeError(f"Cc must be float32 or bfloat16, got {Cc.dtype}")
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    if H == 0 or x.shape[3] % H:
        raise ValueError(f"H={H} heads do not split x's {x.shape[3]} "
                         "channels")
    P = x.shape[3] // H
    if (P % PT or l > MAX_L or l % 4 or N > MAX_N or N % PT
            or B * nc > 65535):
        raise ValueError(f"shape outside the kernels' limits: P={P} (a "
                         f"multiple of {PT}), l={l} (<= {MAX_L}, a multiple "
                         f"of 4), N={N} (<= {MAX_N}, a multiple of {PT}), "
                         f"B nc={B * nc} (<= 65535)")
    mm, f32 = Cc.dtype, torch.float32
    want = [("Bc", Bc, (B, nc, l, N), mm),
            ("acum", acum, (B, nc, H, l), f32),
            ("dte", dte, (B, nc, H, l), f32),
            ("cdec", cdec, (B, nc, H), f32),
            ("dtp", dtp, (B, nc, H, l), f32),
            ("x", x, (B, nc, l, H * P), mm)]
    if Ssave is not None:
        want.append(("Ssave", Ssave, (B, nc, H, P, N), mm))
    if dy is not None:
        want.append(("dy", dy, (B, nc, l, H * P), mm))
    for name, t, shape, dtype in want:
        if t.device != Cc.device:
            raise ValueError(f"{name} is on {t.device}, Cc on {Cc.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for name, t in [("Cc", Cc)] + [(n, t) for n, t, _, _ in want]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_fwd_cuda(Cc, Bc, acum, dte, cdec, dtp, x, want_save=False):
    """The forward kernel's wrapper: checks, allocates y, the entering
    states (Ssave; without ``want_save`` a workspace of its shape, which
    the output pass reads) and the workspaces, launches on the current
    stream, counts."""
    _check_cuda_args(Cc, Bc, acum, dte, cdec, dtp, x)
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    P = x.shape[3] // H
    dev, mm = Cc.device, Cc.dtype
    y = torch.empty_like(x)
    Ssave = torch.empty(B, nc, H, P, N, dtype=mm, device=dev)
    scores = torch.empty(B, nc, l, l, dtype=torch.float32, device=dev)
    pre = torch.empty(2, B, nc, H, l, P, dtype=mm, device=dev)  # dtx rows
    ptrs = [t.data_ptr() for t in (Cc, Bc, acum, dte, cdec, dtp, x, y, Ssave,
                                   scores, pre)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7
             + [ctypes.c_void_p],
             ptrs + [B, nc, l, H, P, N, int(mm == torch.bfloat16), stream])
    ssd_fused_fwd.launches += 1
    return (y, Ssave) if want_save else y


def _launch_bwd_cuda(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy):
    """The backward kernel's wrapper: checks, allocates the outputs, the
    workspaces and the per-block fp32 partials, launches, counts, and sums
    the partials (no atomics: the same bits on every run)."""
    _check_cuda_args(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy)
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    P = x.shape[3] // H
    f32 = dict(dtype=torch.float32, device=Cc.device)
    nt, npt, nnt = (-(-n // BWD_TILE) for n in (l, P, N))
    dx = torch.empty_like(x)
    dso = torch.empty_like(Ssave)                 # rounded dS entering each
    scores = torch.empty(B, nc, l, l, **f32)      # chunk
    dsr = torch.empty(B, nc, l, l, dtype=Cc.dtype, device=Cc.device)
    pre = torch.empty(3, B, nc, H, l, P, dtype=Cc.dtype, device=Cc.device)
    row_part = torch.empty(B, nc, H, nt, l, **f32)
    col_part = torch.empty(B, nc, H, nt, l, **f32)
    off_part = torch.empty(B, nc, H, npt, l, **f32)
    ddte_part = torch.empty(B, nc, H, npt, l, **f32)
    ddtp_part = torch.empty(B, nc, H, npt, l, **f32)
    dcdec_part = torch.empty(B, nc, H, npt * nnt, **f32)
    dC, dB = torch.empty_like(Cc), torch.empty_like(Bc)
    ptrs = [t.data_ptr() for t in (
        Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy, dx, dso, scores, dsr,
        pre, row_part, col_part, off_part, ddte_part, ddtp_part, dcdec_part,
        dC, dB)]
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs)
             + [ctypes.c_int] * 7 + [ctypes.c_void_p],
             ptrs + [B, nc, l, H, P, N, int(Cc.dtype == torch.bfloat16),
                     stream])
    ssd_fused_bwd.launches += 1
    dacum = row_part.sum(3) - col_part.sum(3) + off_part.sum(3)
    return (dC, dB, dacum, ddte_part.sum(3), dcdec_part.sum(3),
            ddtp_part.sum(3), dx)


def _pass_info(kernel: str, dtype, passes) -> dict:
    """What the card grants each of ``passes`` as ``kernel`` builds them
    for operand type ``dtype``: {pass: (registers a thread, local-memory
    bytes a thread (spills), dynamic shared bytes a block, resident warps
    per SM)}, from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from medical_image_classification_tpu_torch.kernels import _build
    lib = _build.library(kernel)
    fn = getattr(lib, f"{kernel}_pass_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (4 * len(passes)))()
    _build.raise_on_error(lib, kernel, fn(int(dtype == torch.bfloat16),
                                          ctypes.addressof(out)))
    return {p: tuple(out[4 * i:4 * i + 4]) for i, p in enumerate(passes)}


def fwd_pass_info(kernel: str, dtype) -> dict:
    """``_pass_info`` of the walk's forward passes (``FWD_PASSES``) as
    ``kernel`` ("ssd_fused_fwd" or "ssd_fused_dirs_fwd") builds them."""
    return _pass_info(kernel, dtype, FWD_PASSES)


def bwd_pass_info(kernel: str, dtype) -> dict:
    """``_pass_info`` of the walk's backward passes (``BWD_PASSES``) as
    ``kernel`` ("ssd_fused_bwd" or "ssd_fused_dirs_bwd") builds them."""
    return _pass_info(kernel, dtype, BWD_PASSES)


# --------------------------------------------------------------------------
# dispatchers


def ssd_fused_fwd(Cc, Bc, acum, dte, cdec, dtp, x, want_save: bool = False,
                  impl: str = "auto"):
    """The forward: y, and Ssave when ``want_save``.  ``impl``: "auto",
    "cuda" or "torch" (``kernels/_dispatch.py``)."""
    impl = resolve_impl(impl, Cc, "SSD")
    if not via_op(impl, Cc):
        return ssd_fused_fwd_ref(Cc, Bc, acum, dte, cdec, dtp, x, want_save)
    outs = ops.ssd_fused_fwd(Cc, Bc, acum, dte, cdec, dtp, x, want_save,
                             impl)
    return tuple(outs) if want_save else outs[0]


def op_forward(Cc, Bc, acum, dte, cdec, dtp, x, want_save, impl):
    """The body of ``ops.ssd_fused_fwd``: the kernel (``impl`` "cuda";
    on dense copies where an operand is not 16-byte aligned) or the plain
    version ("torch"); [y, Ssave?]."""
    args = (Cc, Bc, acum, dte, cdec, dtp, x)
    if impl == "cuda":
        outs = _launch_fwd_cuda(*(dense(t) for t in args), want_save)
    else:
        outs = ssd_fused_fwd_ref(*args, want_save)
    return list(outs) if want_save else [outs]


def ssd_fused_bwd(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy,
                  impl: str = "auto"):
    """The backward: (dC, dB, dacum, ddte, dcdec, ddtp, dx).  ``impl`` as
    in ``ssd_fused_fwd``."""
    impl = resolve_impl(impl, Cc, "SSD")
    if not via_op(impl, Cc):
        return ssd_fused_bwd_ref(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy)
    return tuple(ops.ssd_fused_bwd(Cc, Bc, acum, dte, cdec, dtp, x, Ssave,
                                   dy, impl))


def op_backward(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy, impl):
    """The body of ``ops.ssd_fused_bwd``: the kernel (``impl`` "cuda";
    on dense copies where needed) or the plain version ("torch"); the
    cotangents in their primals' dtypes."""
    args = (Cc, Bc, acum, dte, cdec, dtp, x)
    if impl == "cuda":
        grads = _launch_bwd_cuda(*(dense(t) for t in args + (Ssave, dy)))
    else:
        grads = ssd_fused_bwd_ref(*args, Ssave, dy)
    return [g.to(p.dtype) for g, p in zip(grads, args)]


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
ssd_fused_fwd.launches = 0
ssd_fused_bwd.launches = 0


class SSDFused(torch.autograd.Function):
    """``ssd_fused`` under autograd (the JAX custom VJP): the forward saves
    Ssave, the backward takes the cotangent to x's dtype and runs the
    backward kernel or the plain backward by the same ``impl``."""

    @staticmethod
    def forward(ctx, Cc, Bc, acum, dte, cdec, dtp, x, impl):
        y, Ssave = ssd_fused_fwd(Cc, Bc, acum, dte, cdec, dtp, x,
                                 want_save=True, impl=impl)
        ctx.save_for_backward(Cc, Bc, acum, dte, cdec, dtp, x, Ssave)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        *args, Ssave = ctx.saved_tensors
        x = args[-1]
        return ssd_fused_bwd(*args, Ssave, dy.to(x.dtype).contiguous(),
                             impl=ctx.impl) + (None,)


def ssd_fused(Cc, Bc, acum, dte, cdec, dtp, x, impl: str = "auto"):
    """The single-layout fused SSD (see the module docstring).  With grad
    enabled and an input that requires grad, the call goes through
    ``SSDFused``; otherwise only the forward runs, without saved states.
    acum, dte, cdec and dtp are taken to fp32 and every operand made
    contiguous here, inside the autograd graph (the kernels' wrappers copy
    an operand that is not 16-byte aligned)."""
    impl = resolve_impl(impl, Cc, "SSD")
    args = (Cc.contiguous(), Bc.contiguous()) + tuple(
        t.float().contiguous() for t in (acum, dte, cdec, dtp)) + (
        x.contiguous(),)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDFused.apply(*args, impl)
    return ssd_fused_fwd(*args, impl=impl)
