"""The ST-SSD semantic-token mixer: the gate, the plain forward and
backward, the CUDA kernels' wrappers and dispatchers, and the autograd
Function that joins them.

Port of ``medical_image_classification_tpu/kernels/stl_mixer_pallas.py``
(``stl_mixer_supported``, ``stl_mixer``, the forward body ``_fwd_kernel``,
the backward body ``_bwd_kernel`` and the custom VJP ``_mixer``).  Kernels:
``csrc/stl_mixer_fwd.cu`` and ``csrc/stl_mixer_bwd.cu``.

  S = w u1            [L, P]  summed in fp32 over operand-type values
  E = softmax_P(S)            in fp32, then rounded to the operand dtype
  U = E^T V           [P, C]  summed in fp32, written in w's dtype

with w [BB, L, C] (the four directions folded into the batch), u1 [C, P],
V = w u2 [BB, L, C] (a plain matmul outside the kernel, as the JAX caller
computes it) and U [BB, P, C].  The forward also gives each row's
log-sum-exp lse = log(sum over P of exp(S)) [BB, L] fp32, so that the
backward has E = exp(S - lse) without a walk over P of its own.

The backward, at the TPU body's rounding points (dU taken to w's dtype):
  dV  = rnd(E) dU                       E the fp32 softmax
  dE  = V dU^T,  rowdot = rowsums(E * dE)
  dS  = rnd(E * (dE - rowdot))
  dw  = dS u1^T,  du1 = (sum over BB of dS^T w)^T    fp32 sums, rounded
"""

from __future__ import annotations

import ctypes

import torch

from medical_image_classification_tpu_torch.kernels import ops
from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    dense,
    pass_info,
    resolve_impl,
    via_op,
)

_FWD_KERNEL = "stl_mixer_fwd"
_BWD_KERNEL = "stl_mixer_bwd"
_DTYPES = (torch.float32, torch.bfloat16)
# below this much mixer work the JAX package keeps XLA's softmax; a module
# constant so that tests can widen the gate to small shapes
_MIN_LP = 512 * 512
# channel widths the CUDA kernels are instantiated for (a warp holds 16
# output rows of 128 (bf16) or 64 (fp32) channels in fp32 registers)
KERNEL_C = (128, 256)
# the kernels' step along the walked axis (Cfg::kStep in
# csrc/stl_mixer_tiles.cuh), which the decomposition twins follow
STEP = {torch.bfloat16: 64, torch.float32: 32}


def stl_mixer_supported(L: int, P: int, C: int) -> bool:
    """The shape terms of the JAX gate (``stl_mixer_pallas.py:73-82``),
    without its backend term and its VMEM fit (``_pick_lt``)."""
    return L * P >= _MIN_LP and L % 8 == 0 and P % 8 == 0 and C % 128 == 0


def stl_mixer_fwd_ref(w, u1, V, want_stats=False):
    """Plain PyTorch version of the kernel (see the module docstring): U,
    and with ``want_stats`` (U, lse)."""
    mm = w.dtype
    S = w.float() @ u1.to(mm).float()
    E = torch.softmax(S, dim=-1).to(mm)
    U = (E.float().transpose(1, 2) @ V.to(mm).float()).to(mm)
    return (U, torch.logsumexp(S, dim=-1)) if want_stats else U


def stl_mixer_bwd_ref(w, u1, V, dU, lse=None):
    """Plain PyTorch version of the backward kernel: (dw, du1, dV), the
    cotangents of the forward's operands (see the module docstring).  E is
    exp(S - lse) given the forward's ``lse``, else the softmax of S."""
    mm = w.dtype
    w32, u132 = w.float(), u1.to(mm).float()
    dU32 = dU.to(mm).float()
    S = w32 @ u132                                           # [BB, L, P]
    E = (torch.softmax(S, dim=-1) if lse is None
         else torch.exp(S - lse[..., None]))
    dV = (E.to(mm).float() @ dU32).to(V.dtype)
    dE = V.to(mm).float() @ dU32.transpose(1, 2)
    dS = (E * (dE - (E * dE).sum(-1, keepdim=True))).to(mm).float()
    dw = (dS @ u132.t()).to(w.dtype)
    du1 = (dS.transpose(1, 2) @ w32).sum(0).t().to(u1.dtype)
    return dw, du1, dV


def _lane_stats(S, step, nw):
    """The forward row pass's statistics in plain PyTorch: a thread keeps
    the running max m and sum n of exp(S - m) of the columns it holds (the
    warp's share of each step, ``step // nw`` columns, and in every run of
    8 the lane's pair 2q, 2q + 1), rescaling n when m grows from step to
    step; the classes are then merged, lse = m + log(n).  S [BB, L, P]
    fp32 -> lse [BB, L]."""
    BB, L, P = S.shape
    p = torch.arange(P, device=S.device)
    cls = ((p % step) // (step // nw)) * 4 + (p % 8) // 2
    ninf = torch.tensor(float("-inf"), device=S.device)
    m = torch.full((4 * nw, BB, L), float("-inf"), device=S.device)
    n = torch.zeros(4 * nw, BB, L, device=S.device)
    for p0 in range(0, P, step):
        Sb, cb = S[..., p0:p0 + step], cls[p0:p0 + step]
        for k in range(4 * nw):
            x = Sb[..., cb == k]
            if x.shape[-1] == 0:
                continue
            mx = torch.maximum(m[k], x.amax(-1))
            n[k] = n[k] * torch.exp(m[k] - mx) + torch.exp(
                x - mx[..., None]).sum(-1)
            m[k] = mx
    mx = m.amax(0)
    n = torch.where(m > ninf, n * torch.exp(m - mx), 0.0).sum(0)
    return mx + torch.log(n)


def stl_mixer_fwd_passes_ref(w, u1, V):
    """The forward kernels' decomposition (``csrc/stl_mixer_fwd.cu``) in
    plain PyTorch: (U, lse).  The row pass's lse from per-lane statistics
    (``_lane_stats``, with the kernels' step and warps per row); the
    column pass's U = sum over steps of L of rnd(exp(S - lse))^T V, each
    step's product summed in fp32."""
    mm = w.dtype
    BB, L, C = w.shape
    step = STEP[mm]
    nw = C // (128 if mm == torch.bfloat16 else 64)
    w32, u132, V32 = w.float(), u1.to(mm).float(), V.to(mm).float()
    lse = _lane_stats(w32 @ u132, step, nw)
    U = torch.zeros(BB, u1.shape[1], C, device=w.device)
    for l0 in range(0, L, step):
        sl = slice(l0, l0 + step)
        E = torch.exp(w32[:, sl] @ u132 - lse[:, sl, None]).to(mm).float()
        U += E.transpose(1, 2) @ V32[:, sl]
    return U.to(mm), lse


def stl_mixer_bwd_passes_ref(w, u1, V, dU, lse):
    """The backward kernels' decomposition (``csrc/stl_mixer_bwd.cu``) in
    plain PyTorch: (dw, du1, dV) from the forward's lse.  Row pass, walk 1
    over steps of P: rowdot += rowsums(E dE) and dV += rnd(E) dU; walk 2:
    dw += rnd(E (dE - rowdot)) u1^T.  Column pass over steps of L: the
    per-batch du1 partials += dS^T w, summed over the batch at the end."""
    mm = w.dtype
    BB, L, C = w.shape
    P = u1.shape[1]
    step = STEP[mm]
    w32, u132 = w.float(), u1.to(mm).float()
    V32, dU32 = V.to(mm).float(), dU.to(mm).float()

    def tile(rows, cols):
        S = w32[:, rows] @ u132[:, cols]
        dE = V32[:, rows] @ dU32[:, cols].transpose(1, 2)
        return torch.exp(S - lse[:, rows, None]), dE

    rowdot = torch.zeros(BB, L, device=w.device)
    dV = torch.zeros(BB, L, C, device=w.device)
    for p0 in range(0, P, step):
        cols = slice(p0, p0 + step)
        E, dE = tile(slice(None), cols)
        rowdot += (E * dE).sum(-1)
        dV += E.to(mm).float() @ dU32[:, cols]
    dw = torch.zeros(BB, L, C, device=w.device)
    for p0 in range(0, P, step):
        cols = slice(p0, p0 + step)
        E, dE = tile(slice(None), cols)
        dS = (E * (dE - rowdot[..., None])).to(mm).float()
        dw += dS @ u132[:, cols].t()
    du1p = torch.zeros(BB, P, C, device=w.device)
    for l0 in range(0, L, step):
        rows = slice(l0, l0 + step)
        E, dE = tile(rows, slice(None))
        dS = (E * (dE - rowdot[:, rows, None])).to(mm).float()
        du1p += dS.transpose(1, 2) @ w32[:, rows]
    return (dw.to(w.dtype), du1p.sum(0).t().to(u1.dtype), dV.to(V.dtype))


def _check_cuda_args(w, u1, V, dU=None, lse=None):
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
    named = [("u1", u1, (C, P)), ("V", V, (BB, L, C))]
    if dU is not None:
        named.append(("dU", dU, (BB, P, C)))
    named = [(n, t, shape, w.dtype) for n, t, shape in named]
    if lse is not None:
        named.append(("lse", lse, (BB, L), torch.float32))
    for name, t, shape, dtype in named:
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for name, t in [("w", w)] + [(n, t) for n, t, _, _ in named]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16-byte vectors)")


def _launch_fwd_cuda(w, u1, V):
    """The forward kernels' wrapper: checks, allocates U and the rows'
    lse [BB, L] fp32, launches both passes on the current stream, counts
    one launch; returns (U, lse)."""
    _check_cuda_args(w, u1, V)
    BB, L, C = w.shape
    P = u1.shape[1]
    U = torch.empty(BB, P, C, dtype=w.dtype, device=w.device)
    lse = torch.empty(BB, L, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        call(_FWD_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             [w.data_ptr(), u1.data_ptr(), V.data_ptr(), U.data_ptr(),
              lse.data_ptr(), BB, L, P, C, int(w.dtype == torch.bfloat16),
              stream])
    stl_mixer_fwd.launches += 1
    return U, lse


def _launch_bwd_cuda(w, u1, V, dU, lse):
    """The backward kernels' wrapper: checks, allocates dw, dV, the
    [BB, L] fp32 rowdot workspace and the per-batch fp32 du1 partials
    [BB, P, C], launches both passes, counts one launch, and sums the
    partials over the batch (no atomics: the same bits on every run)."""
    _check_cuda_args(w, u1, V, dU, lse)
    BB, L, C = w.shape
    P = u1.shape[1]
    f32 = dict(dtype=torch.float32, device=w.device)
    dw, dV = torch.empty_like(w), torch.empty_like(V)
    rowdot = torch.empty(BB, L, **f32)
    du1_part = torch.empty(BB, P, C, **f32)
    ptrs = [t.data_ptr() for t in (w, u1, V, dU, lse, dw, dV, rowdot,
                                   du1_part)]
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        call(_BWD_KERNEL, [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
             + [ctypes.c_void_p],
             ptrs + [BB, L, P, C, int(w.dtype == torch.bfloat16), stream])
    stl_mixer_bwd.launches += 1
    return dw, du1_part.sum(0).t().to(u1.dtype), dV


def fwd_pass_info(C: int, dtype) -> dict:
    """What the card grants the forward's passes at channels ``C`` and
    operand type ``dtype`` (``_dispatch.pass_info``): {"rows" | "cols":
    (registers, local bytes, shared bytes, warps per SM)}."""
    return pass_info(_FWD_KERNEL, ("rows", "cols"), C, dtype)


def bwd_pass_info(C: int, dtype) -> dict:
    """The same for the backward's passes."""
    return pass_info(_BWD_KERNEL, ("rows", "cols"), C, dtype)


def stl_mixer_fwd(w, u1, V, impl: str = "auto", want_stats: bool = False):
    """U = softmax_P(w u1)^T V (see the module docstring), and with
    ``want_stats`` (U, lse).  ``impl``: "auto", "cuda" or "torch"
    (``kernels/_dispatch.py``)."""
    impl = resolve_impl(impl, w, "STL mixer")
    if not via_op(impl, w):
        return stl_mixer_fwd_ref(w, u1, V, want_stats)
    U, lse = ops.stl_mixer_fwd(w, u1, V, impl)
    return (U, lse) if want_stats else U


def op_forward(w, u1, V, impl):
    """The body of ``ops.stl_mixer_fwd``: (U, lse) from the kernels
    (``impl`` "cuda"; on dense copies in w's dtype) or from the plain
    version ("torch")."""
    if impl == "cuda":
        return _launch_fwd_cuda(dense(w), dense(u1.to(w.dtype)),
                                dense(V.to(w.dtype)))
    return stl_mixer_fwd_ref(w, u1, V, True)


def stl_mixer_bwd(w, u1, V, dU, impl: str = "auto", lse=None):
    """The backward: (dw, du1, dV), E from the forward's ``lse`` (the
    kernels need it; the plain version takes the softmax without it).
    ``impl`` as in ``stl_mixer_fwd``."""
    if resolve_impl(impl, w, "STL mixer") == "torch":
        return stl_mixer_bwd_ref(w, u1, V, dU, lse)
    if lse is None:
        raise ValueError("the STL mixer's backward kernels take the "
                         "forward's lse (stl_mixer_fwd(..., want_stats="
                         "True))")
    mm = w.dtype
    return _launch_bwd_cuda(dense(w), dense(u1.to(mm)), dense(V.to(mm)),
                            dense(dU.to(mm)), dense(lse))


# Number of CUDA kernel launches so far; each wrapper adds one per launch,
# and nothing else changes them except a caller resetting them to 0.
stl_mixer_fwd.launches = 0
stl_mixer_bwd.launches = 0


class STLMixer(torch.autograd.Function):
    """``softmax_P(w u1)^T V`` under autograd (the JAX custom VJP
    ``_mixer``): the backward takes the cotangent to w's dtype and runs the
    backward kernel or the plain backward by the same ``impl``.  The
    forward saves its operands and the rows' lse [BB, L], so the backward
    has E without a walk of its own over P."""

    @staticmethod
    def forward(ctx, w, u1, V, impl):
        U, lse = stl_mixer_fwd(w, u1, V, impl=impl, want_stats=True)
        ctx.save_for_backward(w, u1, V, lse)
        ctx.impl = impl
        return U

    @staticmethod
    def backward(ctx, dU):
        w, u1, V, lse = ctx.saved_tensors
        return stl_mixer_bwd(w, u1, V, dU.to(w.dtype), ctx.impl,
                             lse) + (None,)


def stl_mixer(w, u1, u2, impl: str = "auto"):
    """The fused token mixer ``softmax_P(w u1)^T (w u2)``: w [BB, L, C],
    u1 [C, P], u2 [C, C] -> U [BB, P, C].  The caller has checked
    ``stl_mixer_supported``.  V = w u2 is a plain matmul outside the
    kernels, as in the JAX package, so autograd carries dV on to dw and
    du2.  With grad enabled and an operand that requires grad, the mixer
    goes through ``STLMixer``; otherwise only the forward runs."""
    impl = resolve_impl(impl, w, "STL mixer")
    V = torch.matmul(w, u2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, u1, V)):
        return STLMixer.apply(w, u1, V, impl)
    return stl_mixer_fwd(w, u1, V, impl=impl)
