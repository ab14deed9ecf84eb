"""The SSD intra-chunk output Y_diag: the gate, the plain forward and
backward, the CUDA kernels' wrappers and dispatchers, and the autograd
Function that joins them.

Port of ``medical_image_classification_tpu/kernels/ssd_ydiag_pallas.py``
(``ydiag_supported``, the forward body ``_fwd_kernel``, the backward body
``_bwd_kernel`` and the custom VJP ``ydiag_fused``).  Kernels:
``csrc/ssd_ydiag_fwd.cu`` (one pass, the rows strip of
``csrc/ssd_ydiag_strip.cuh``) and ``csrc/ssd_ydiag_bwd.cu`` (in bf16 three:
the SSD walk backward's intra pass, the columns strip, the walk's flush
pass; in fp32 the two passes of the first port, which run faster there);
``ydiag_fwd_passes_ref`` and ``ydiag_bwd_passes_ref`` are their
decomposition in plain PyTorch.

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

The backward, at the TPU body's rounding points (dy taken to dtx's dtype):
  ddtx[s]  = sum_{i >= s} rnd(M)[i, s] dy[i]           rounded to dtx's dtype
  dM       = dy dtx^T                                   fp32
  G        = dM * M,  dacum = rowsums(G) - colsums(G)   M and G unrounded fp32
  dscores  = rnd(sum over the H heads of dM * decay)    summed in fp32
  dC = dscores Bc,  dB = dscores^T Cc                   rounded to their dtypes
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
from medical_image_classification_tpu_torch.kernels.ssd_fused import (
    _pass_info,
)

_FWD_KERNEL = "ssd_ydiag_fwd"
_BWD_KERNEL = "ssd_ydiag_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# The chunk window of the gate; module constants so that tests can widen
# it to small shapes, as the JAX package's tests patch its ``_MIN_L``.
_MIN_L = 224
_MAX_L = 256
# The kernels' tiles (kT of csrc/ssd_ydiag_strip.cuh and of the walks'
# csrc/ssd_walk_tiles.cuh): rows, columns, N and P in 64s; the
# decomposition twins follow them.
TILE = 64
# shape limits of the CUDA kernels: a strip keeps all of a chunk's MAX_L
# columns; N is tiled, so it does not bound shared memory, and MAX_N is the
# widest state the card's checks cover (MedSSD's N 512); the backward's
# flush pass stores N in 32s; the 16-byte pieces of every tile copy need
# l % 4 and P % 8; the fp32 backward keeps a head's [64, P] cotangent tile
# in one 64-wide accumulator (bf16 takes the same P, one rule for the gate)
MAX_L = 256
MAX_N = 512
N_STEP = 32
MAX_P_BWD = 64
FWD_PASSES = ("rows",)
BWD_PASSES = {torch.bfloat16: ("intra", "cols", "flush"),
              torch.float32: ("grad", "dcb")}


def ydiag_supported(l: int, N: int, P: int, G: int, card: bool = False,
                    BC: int = 1, dtype: torch.dtype = torch.float32) -> bool:
    """The shape terms of the JAX gate (``ssd_ydiag_pallas.py:127-128``),
    without its backend term and its VMEM fit (``_pick_hb``).  ``card``:
    the operands lie on the GPU, where the CUDA kernels also need what
    ``_check_cuda_args`` asks of the forward and the backward beyond those
    terms: N <= ``MAX_N``, P <= ``MAX_P_BWD``, BC <= 65535 and a float32 or
    bfloat16 dtype (l <= ``MAX_L``, l % 4, N % ``N_STEP`` and P % 8 follow
    from the shape terms); elsewhere the plain version takes any of these
    shapes."""
    if not (G == 1 and _MIN_L <= l <= _MAX_L and l % 8 == 0 and N % 64 == 0
            and P % 8 == 0):
        return False
    return not card or (N <= MAX_N and P <= MAX_P_BWD and BC <= 65535
                        and dtype in _DTYPES)


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


def ydiag_fused_bwd_ref(Cc, Bc, acum, dtx, dy):
    """Plain PyTorch version of the backward kernel: (dCc, dBc, dacum,
    ddtx), the cotangents of the forward's operands (see the module
    docstring)."""
    mm = Cc.dtype
    l = Cc.shape[1]
    C32, B32 = Cc.float(), Bc.float()
    scores = C32 @ B32.transpose(1, 2)                       # [BC, l, l]
    causal = torch.ones(l, l, dtype=torch.bool, device=Cc.device).tril()
    seg = (acum[..., :, None] - acum[..., None, :]).masked_fill(~causal, 0.0)
    E = torch.where(causal, torch.exp(seg), 0.0)             # [BC, H, l, l]
    M = scores[:, None] * E
    dy32 = dy.to(mm).float()
    ddtx = (M.to(mm).float().transpose(2, 3) @ dy32).to(dtx.dtype)
    dM = dy32 @ dtx.to(mm).float().transpose(2, 3)
    G = dM * M
    dacum = G.sum(-1) - G.sum(-2)
    ds = (dM * E).sum(1).to(mm).float()                      # [BC, l, l]
    dC = (ds @ B32).to(Cc.dtype)
    dB = (ds.transpose(1, 2) @ C32).to(Bc.dtype)
    return dC, dB, dacum, ddtx


def _tiles(l):
    """The kernels' 64-wide tiles of a chunk of l rows: [(t0, t1), ...]."""
    return [(t0, min(l, t0 + TILE)) for t0 in range(0, l, TILE)]


def _slab_scores(X, Y):
    """X Y^T [BC, m, n] in fp32, summed over N in the kernels' 64-wide
    slabs (fp32 X [BC, m, N], Y [BC, n, N])."""
    out = 0.0
    for n0 in range(0, X.shape[-1], TILE):
        out = out + X[..., n0:n0 + TILE] @ Y[..., n0:n0 + TILE].transpose(1, 2)
    return out


def _masked_decay(acum, i, j):
    """exp(a_i - a_j) [BC, H, len(i), len(j)] for the chunk rows i and
    columns j (ranges), 0 where j > i."""
    ii = torch.arange(*i, device=acum.device)
    jj = torch.arange(*j, device=acum.device)
    causal = jj[None, :] <= ii[:, None]
    seg = acum[:, :, i[0]:i[1], None] - acum[:, :, None, j[0]:j[1]]
    return torch.where(causal, torch.exp(seg.masked_fill(~causal, 0.0)), 0.0)


def _strip_product(A, V, c0, c1):
    """sum over the strip's columns c0..c1 of A V as the strip pass sums
    it, one 64-wide column tile after the other (A [BC, H, m, c1 - c0]
    rounded, V [BC, H, l, P] fp32)."""
    out = 0.0
    for t0 in range(c0, c1, TILE):
        t1 = min(c1, t0 + TILE)
        out = out + A[..., t0 - c0:t1 - c0] @ V[:, :, t0:t1]
    return out


def ydiag_fwd_passes_ref(Cc, Bc, acum, dtx):
    """The forward kernel's decomposition (``csrc/ssd_ydiag_fwd.cu``) in
    plain PyTorch: per 64-row strip r0.. of a chunk, its scores C B^T over
    the columns j < r0 + 64 (fp32, N in 64s), then per head y = the strip
    product of rnd(scores exp(a_i - a_j)) (masked j > i) with dtx."""
    mm = Cc.dtype
    BC, l, _ = Cc.shape
    C32, B32, x32 = Cc.float(), Bc.float(), dtx.to(mm).float()
    y = torch.empty_like(dtx)
    for r0, r1 in _tiles(l):
        S = _slab_scores(C32[:, r0:r1], B32[:, :r1])        # [BC, m, r1]
        M = (S[:, None] * _masked_decay(acum, (r0, r1), (0, r1))).to(mm)
        y[:, :, r0:r1] = _strip_product(M.float(), x32, 0, r1).to(dtx.dtype)
    return y


def ydiag_bwd_passes_ref(Cc, Bc, acum, dtx, dy):
    """The backward kernels' decomposition (``csrc/ssd_ydiag_bwd.cu``) in
    plain PyTorch: (dCc, dBc, dacum, ddtx).  The intra pass per lower
    64 x 64 tile: its scores (fp32, N in 64s), then the heads in turn: dM =
    dy dtx^T over P in 64s, dscores += dM decay in fp32, rounded once to
    the operand type (the workspace dsr), G's row sums per column tile and
    column sums per row tile as fp32 partials, summed at the end; the
    columns strip pass ddtx = the strip product of rnd(M)^T with dy; the
    flush pass dC = dsr B and dB = dsr^T C in 64-deep stages over the causal
    tiles.  The fp32 kernels (the first port's two passes) compute the same
    fp32 sums over the same 64-wide tiles in another order."""
    mm = Cc.dtype
    BC, l, _ = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    C32, B32 = Cc.float(), Bc.float()
    x32, dy32 = dtx.to(mm).float(), dy.to(mm).float()
    tiles = _tiles(l)
    f32 = dict(dtype=torch.float32, device=Cc.device)
    dsr = torch.zeros(BC, l, l, dtype=mm, device=Cc.device)
    row_part = torch.zeros(BC, H, len(tiles), l, **f32)
    col_part = torch.zeros(BC, H, len(tiles), l, **f32)
    for it, (i0, i1) in enumerate(tiles):
        for jt, (j0, j1) in enumerate(tiles[:it + 1]):
            sc = _slab_scores(C32[:, i0:i1], B32[:, j0:j1])
            E = _masked_decay(acum, (i0, i1), (j0, j1))
            ds = torch.zeros_like(sc)
            for h in range(H):
                dM = 0.0
                for p0 in range(0, P, TILE):
                    dM = dM + (dy32[:, h, i0:i1, p0:p0 + TILE]
                               @ x32[:, h, j0:j1, p0:p0 + TILE].transpose(1, 2))
                ds = ds + dM * E[:, h]
                G = dM * (sc * E[:, h])
                row_part[:, h, jt, i0:i1] = G.sum(2)
                col_part[:, h, it, j0:j1] = G.sum(1)
            dsr[:, i0:i1, j0:j1] = ds.to(mm)
    ddtx = torch.empty_like(dtx)
    for j0, j1 in tiles:
        St = _slab_scores(B32[:, j0:j1], C32[:, j0:])       # [BC, m, l - j0]
        E = _masked_decay(acum, (j0, l), (j0, j1)).transpose(2, 3)
        Mt = (St[:, None] * E).to(mm).float()
        ddtx[:, :, j0:j1] = _strip_product(Mt, dy32, j0, l).to(dtx.dtype)
    ds32 = dsr.float()
    dC, dB = torch.empty_like(Cc), torch.empty_like(Bc)
    for rt, (r0, r1) in enumerate(tiles):
        accC = accB = 0.0
        for k0, k1 in tiles[:rt + 1]:
            accC = accC + ds32[:, r0:r1, k0:k1] @ B32[:, k0:k1]
        for k0, k1 in tiles[rt:]:
            accB = accB + ds32[:, k0:k1, r0:r1].transpose(1, 2) @ C32[:, k0:k1]
        dC[:, r0:r1] = accC.to(Cc.dtype)
        dB[:, r0:r1] = accB.to(Bc.dtype)
    return dC, dB, row_part.sum(2) - col_part.sum(2), ddtx


def _check_cuda_args(Cc, Bc, acum, dtx, dy=None):
    """Raise on operands the kernels do not take; ``dy`` (the backward's
    cotangent) also limits P to ``MAX_P_BWD``."""
    if Cc.dim() != 3 or dtx.dim() != 4:
        raise ValueError(f"Cc must be [BC, l, N] and dtx [BC, H, l, P], got "
                         f"{tuple(Cc.shape)} and {tuple(dtx.shape)}")
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    if Cc.dtype not in _DTYPES or dtx.dtype != Cc.dtype:
        raise TypeError(f"Cc and dtx must both be float32 or bfloat16, got "
                        f"{Cc.dtype} and {dtx.dtype}")
    if (l > MAX_L or l % 4 or N > MAX_N or N % N_STEP or P % 8
            or BC > 65535 or (dy is not None and P > MAX_P_BWD)):
        raise ValueError(f"shape outside the kernels' limits: l={l} (<= "
                         f"{MAX_L}, a multiple of 4), N={N} (<= {MAX_N}, a "
                         f"multiple of {N_STEP}), P={P} (a multiple of 8, "
                         f"<= {MAX_P_BWD} in the backward), BC={BC} (<= "
                         "65535)")
    named = [("Bc", Bc, (BC, l, N), Cc.dtype),
             ("acum", acum, (BC, H, l), torch.float32),
             ("dtx", dtx, (BC, H, l, P), Cc.dtype)]
    if dy is not None:
        named.append(("dy", dy, (BC, H, l, P), Cc.dtype))
    for name, t, shape, dtype in named:
        if t.device != Cc.device:
            raise ValueError(f"{name} is on {t.device}, Cc on {Cc.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for name, t in [("Cc", Cc)] + [(n, t) for n, t, _, _ in named]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernels load 16-byte vectors)")


def _launch_fwd_cuda(Cc, Bc, acum, dtx):
    """The forward kernel's wrapper: checks, allocates y, launches on the
    current stream, counts the launch."""
    _check_cuda_args(Cc, Bc, acum, dtx)
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    y = torch.empty_like(dtx)
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_void_p],
             [Cc.data_ptr(), Bc.data_ptr(), acum.data_ptr(), dtx.data_ptr(),
              y.data_ptr(), BC, l, N, H, P, int(Cc.dtype == torch.bfloat16),
              stream])
    ydiag_fused_fwd.launches += 1
    return y


def _launch_bwd_cuda(Cc, Bc, acum, dtx, dy):
    """The backward kernels' wrapper: checks, allocates the cotangents, the
    head-summed dscores workspace [BC, l, l] in the operand dtype and G's
    per-tile fp32 row and column sums [BC, H, l / 64, l] (fp32: the row
    sums zeroed, the passes writing only the causal ones, and the column
    sums whole, [BC, H, 1, l]), launches, counts, and sums the partials (no
    atomics: the same bits on every run)."""
    _check_cuda_args(Cc, Bc, acum, dtx, dy)
    BC, l, N = Cc.shape
    H, P = dtx.shape[1], dtx.shape[3]
    f32 = dict(dtype=torch.float32, device=Cc.device)
    nt = -(-l // TILE)
    ddtx = torch.empty_like(dtx)
    dsr = torch.empty(BC, l, l, dtype=Cc.dtype, device=Cc.device)
    bf16 = Cc.dtype == torch.bfloat16
    row_part = (torch.empty if bf16 else torch.zeros)(BC, H, nt, l, **f32)
    col_part = torch.empty(BC, H, nt if bf16 else 1, l, **f32)
    dC, dB = torch.empty_like(Cc), torch.empty_like(Bc)
    ptrs = [t.data_ptr() for t in (Cc, Bc, acum, dtx, dy, ddtx, dsr, row_part,
                                   col_part, dC, dB)]
    with torch.cuda.device(Cc.device):
        stream = torch.cuda.current_stream(Cc.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
             + [ctypes.c_void_p],
             ptrs + [BC, l, N, H, P, int(bf16),
                     stream])
    ydiag_fused_bwd.launches += 1
    cols = col_part.sum(2) if bf16 else col_part[:, :, 0]
    return dC, dB, row_part.sum(2) - cols, ddtx


def fwd_pass_info(dtype) -> dict:
    """What the card grants the forward's pass (``FWD_PASSES``) at operand
    type ``dtype``: {pass: (registers a thread, local-memory bytes a thread
    (spills), dynamic shared bytes a block, resident warps per SM)}."""
    return _pass_info(_FWD_KERNEL, dtype, FWD_PASSES)


def bwd_pass_info(dtype) -> dict:
    """The same for the backward's passes at ``dtype``
    (``BWD_PASSES[dtype]``)."""
    return _pass_info(_BWD_KERNEL, dtype, BWD_PASSES[dtype])


def ydiag_fused_fwd(Cc, Bc, acum, dtx, impl: str = "auto"):
    """Y_diag [BC, H, l, P] (see the module docstring).  ``impl``: "auto",
    "cuda" or "torch" (``kernels/_dispatch.py``)."""
    impl = resolve_impl(impl, Cc, "Y_diag")
    if not via_op(impl, Cc):
        return ydiag_fused_ref(Cc, Bc, acum, dtx)
    return ops.ssd_ydiag_fwd(Cc, Bc, acum, dtx, impl)


def op_forward(Cc, Bc, acum, dtx, impl):
    """The body of ``ops.ssd_ydiag_fwd``: the kernel (``impl`` "cuda";
    on dense copies where needed) or the plain version ("torch")."""
    if impl == "cuda":
        return _launch_fwd_cuda(dense(Cc), dense(Bc), dense(acum.float()),
                                dense(dtx))
    return ydiag_fused_ref(Cc, Bc, acum, dtx)


def ydiag_fused_bwd(Cc, Bc, acum, dtx, dy, impl: str = "auto"):
    """The backward: (dCc, dBc, dacum, ddtx).  ``impl`` as in
    ``ydiag_fused_fwd``."""
    impl = resolve_impl(impl, Cc, "Y_diag")
    if not via_op(impl, Cc):
        return ydiag_fused_bwd_ref(Cc, Bc, acum, dtx, dy)
    return tuple(ops.ssd_ydiag_bwd(Cc, Bc, acum, dtx, dy, impl))


def op_backward(Cc, Bc, acum, dtx, dy, impl):
    """The body of ``ops.ssd_ydiag_bwd``: the kernel (``impl`` "cuda";
    on dense copies where needed) or the plain version ("torch"); the
    cotangents in their primals' dtypes."""
    if impl == "cuda":
        grads = _launch_bwd_cuda(dense(Cc), dense(Bc), dense(acum.float()),
                                 dense(dtx), dense(dy))
    else:
        grads = ydiag_fused_bwd_ref(Cc, Bc, acum, dtx, dy)
    return [g.to(p.dtype) for g, p in zip(grads, (Cc, Bc, acum, dtx))]


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
ydiag_fused_fwd.launches = 0
ydiag_fused_bwd.launches = 0


class YDiagFused(torch.autograd.Function):
    """``ydiag_fused`` under autograd (the JAX custom VJP): the backward
    takes the cotangent to dtx's dtype and runs the backward kernel or the
    plain backward by the same ``impl``."""

    @staticmethod
    def forward(ctx, Cc, Bc, acum, dtx, impl):
        ctx.save_for_backward(Cc, Bc, acum, dtx)
        ctx.impl = impl
        return ydiag_fused_fwd(Cc, Bc, acum, dtx, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        Cc, Bc, acum, dtx = ctx.saved_tensors
        return ydiag_fused_bwd(Cc, Bc, acum, dtx, dy.to(dtx.dtype),
                               impl=ctx.impl) + (None,)


def ydiag_fused(Cc, Bc, acum, dtx, impl: str = "auto"):
    """Y_diag [BC, H, l, P] (see the module docstring).  With grad enabled
    and an operand that requires grad, the call goes through
    ``YDiagFused``; otherwise only the forward runs.  acum is taken to
    fp32 and every operand made contiguous here, inside the autograd graph
    (the kernels' wrappers copy an operand that is not 16-byte aligned)."""
    impl = resolve_impl(impl, Cc, "Y_diag")
    args = (Cc.contiguous(), Bc.contiguous(), acum.float().contiguous(),
            dtx.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return YDiagFused.apply(*args, impl)
    return ydiag_fused_fwd(*args, impl=impl)
