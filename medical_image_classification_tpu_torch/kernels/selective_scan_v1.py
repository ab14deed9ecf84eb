"""The v1 selective scan (doubling scan inside chunks of T timesteps) in the
folded layout: the tile chooser, plain versions, CUDA kernel wrappers.

Port of ``medical_image_classification_tpu/kernels/selective_scan_pallas.py``
``_choose_tiles`` and ``_scan_kernel`` / ``_fwd_folded`` (the forward), and
of ``selective_scan_pallas_bwd.py::_bwd_kernel`` / ``bwd_folded`` (the
backward).  The JAX folded entry takes v1 where the tile chooser gives a
chunk T that the two-level kernel's sub-block does not divide (T % 8 != 0);
at the default ``_T_CAP`` T is always a multiple of 8, so only a caller that
sets the cap (``scripts/kernel_bench.py --t-cap``) reaches it.  The port's
folded entry (``selective_scan_fwd.py::scan_folded_fwd``) and ``ScanFolded``
take these kernels exactly there (``v1_chunk``).

v1 has no flags: no reverse scan, no initial or last state, softplus
always on (``check_v1_flags`` raises where the JAX dispatch asserts).
xsave [G, ceil(L / T), N, Dm] fp32 is the state entering each chunk.
Layout as in ``selective_scan_fwd.py``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels._dispatch import (
    call,
    resolve_impl,
)
from medical_image_classification_tpu_torch.kernels.selective_scan_bwd import (
    _sum_partials,
)
from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    _check_cuda_args,
)

# chunk-length cap and working-set budget of the JAX tile chooser
# (selective_scan_pallas.py:52-54), module-level so that a sweep can set
# them as scripts/kernel_bench.py does
_T_CAP = 224
_VMEM_BUDGET = int(8.5 * 1024 * 1024)
_S_SUB = 16          # the two-level kernel's sub-block length

_FWD_KERNEL = "selective_scan_v1_fwd"
_BWD_KERNEL = "selective_scan_v1_bwd"
_WARPS = 8           # channels per block of both kernels (dB/dC partials)
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


def _choose_tiles(L: int, Dm: int, N: int):
    """(T, Dt) as ``selective_scan_pallas.py::_choose_tiles``: Dt divides
    Dm; T the largest multiple of 8 that fits the budget, balanced against
    L; None where no Dt fits."""
    Dt = None
    for cand in (512, 384, 256, 128):
        if Dm % cand == 0:
            Dt = cand
            break
    if Dt is None:
        if Dm <= 512:
            Dt = Dm
        else:
            return None
    per_t = 6 * N * Dt * 4                       # bwd working set per T step
    t_fit = max((_VMEM_BUDGET // per_t) // 8 * 8, 8)
    t_cap = min(_T_CAP, t_fit)
    n_chunks = -(-L // t_cap)
    T = min(t_cap, ((-(-L // n_chunks) + 7) // 8) * 8)
    return T, Dt


def v1_chunk(L: int, Dm: int, N: int):
    """The chunk T when the JAX folded entry takes v1 at this shape (the
    two-level kernel's sub-block, ``_S_SUB`` or else 8, does not divide T;
    ``_fwd_dispatch``, ``scan_bwd``), else None."""
    tiles = _choose_tiles(L, Dm, N)
    if tiles is None:
        return None
    T = tiles[0]
    S = _S_SUB if T % _S_SUB == 0 else 8
    return T if T % S else None


def check_v1_flags(reverse, softplus, want_state, init):
    """v1 computes the forward scan with softplus and no state flags."""
    for name, bad in (("reverse", reverse), ("softplus=False", not softplus),
                      ("want_state", want_state), ("init", init is not None)):
        if bad:
            raise ValueError(f"{name} needs the two-level scan (chunk T a "
                             "multiple of 8); the v1 chunk this shape gets "
                             "from _choose_tiles is not")


def _doubling_scan(a, b):
    """Inclusive Hillis-Steele scan along dim 1 of (a, b) pairs, combine
    (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2); ``_doubling_scan`` of
    selective_scan_pallas_bwd.py:38."""
    T = a.shape[1]
    off = 1
    while off < T:
        a_sh = torch.cat([torch.ones_like(a[:, :off]), a[:, :-off]], dim=1)
        b_sh = torch.cat([torch.zeros_like(b[:, :off]), b[:, :-off]], dim=1)
        b = a * b_sh + b
        a = a * a_sh
        off *= 2
    return a, b


def _padded(T, *ts):
    """[G, L, w] operands in fp32, zero-padded to a multiple of T."""
    L = ts[0].shape[1]
    pad = (-L) % T
    return [F.pad(t.float(), (0, 0, 0, pad)) for t in ts]


def _per_seq(G, *params):
    """[K, ...] parameters repeated over the batch: row g is group g % K."""
    return [p.float().repeat(G // p.shape[0], *([1] * (p.dim() - 1)))
            for p in params]


def scan_v1_fwd_ref(u, delta, A, B, C, D, bias, T: int,
                    want_xsave: bool = True):
    """Plain PyTorch version of ``_fwd_folded``: L padded to a multiple of
    T, chunk by chunk a doubling scan over [G, T, N, Dm], the incoming
    state folded in, the state carried to the next chunk.  Returns y (u's
    dtype, [G, L, Dm]) and, with ``want_xsave``, xsave [G, ceil(L / T), N,
    Dm] fp32."""
    G, L, Dm = u.shape
    uf, df, Bf, Cf = _padded(T, u, delta, B, C)
    Ag, Dg, bg = _per_seq(G, A.transpose(1, 2), D, bias)   # [G, N, Dm], ...
    state = torch.zeros(G, A.shape[2], Dm, dtype=torch.float32,
                        device=u.device)
    ys, xs = [], []
    for t0 in range(0, uf.shape[1], T):
        rows = slice(t0, t0 + T)
        xs.append(state)
        uc = uf[:, rows]
        dt = F.softplus(df[:, rows] + bg[:, None])         # [G, T, Dm]
        a = torch.exp(dt[:, :, None] * Ag[:, None])        # [G, T, N, Dm]
        b = (dt * uc)[:, :, None] * Bf[:, rows, :, None]
        a, b = _doubling_scan(a, b)
        x = b + a * state[:, None]
        ys.append((Cf[:, rows, :, None] * x).sum(2) + uc * Dg[:, None])
        state = x[:, -1]
    y = torch.cat(ys, dim=1)[:, :L].to(u.dtype)
    return (y, torch.stack(xs, dim=1)) if want_xsave else y


def scan_v1_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy, T: int):
    """Plain PyTorch version of ``bwd_folded``: the chunks in reverse, each
    chunk's states recomputed from xsave by the doubling scan, a suffix
    doubling scan for the adjoint g_t = C_t dy_t + a_{t+1} g_{t+1} with the
    carry a_first g_first of the later chunk, the gradients as full-tile
    expressions, and the per-sequence parameter partials summed over the
    batch.  Returns (du, ddelta, dA, dB, dC, dD, dbias), all fp32: du, dΔ
    [G, L, Dm], dA [K, Dm, N], dB, dC [G, L, N], dD, dbias [K, Dm]."""
    G, L, Dm = u.shape
    N = A.shape[2]
    uf, df, Bf, Cf, dyf = _padded(T, u, delta, B, C, dy)
    Ag, Dg, bg = _per_seq(G, A.transpose(1, 2), D, bias)
    f32 = dict(dtype=torch.float32, device=u.device)
    carry = torch.zeros(G, N, Dm, **f32)
    dA_acc = torch.zeros(G, N, Dm, **f32)
    du, ddelta, dB, dC = [], [], [], []
    for t0 in reversed(range(0, uf.shape[1], T)):
        rows = slice(t0, t0 + T)
        uc, Bv, Cv, dyc = uf[:, rows], Bf[:, rows], Cf[:, rows], dyf[:, rows]
        raw = df[:, rows] + bg[:, None]
        dt, sig = F.softplus(raw), torch.sigmoid(raw)
        x_in = xsave[:, t0 // T].float()
        a = torch.exp(dt[:, :, None] * Ag[:, None])            # [G, T, N, Dm]
        a_cum, x_local = _doubling_scan(a, (dt * uc)[:, :, None]
                                        * Bv[..., None])
        x = x_local + a_cum * x_in[:, None]
        x_prev = torch.cat([x_in[:, None], x[:, :-1]], dim=1)
        # suffix scan with â_t = a_{t+1} (â of the last row 1)
        d_acc = Cv[..., None] * dyc[:, :, None]
        a_hat = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        off = 1
        while off < T:
            a_sh = torch.cat([a_hat[:, off:], torch.ones_like(a_hat[:, :off])],
                             dim=1)
            d_sh = torch.cat([d_acc[:, off:], torch.zeros_like(d_acc[:, :off])],
                             dim=1)
            d_acc = d_acc + a_hat * d_sh
            a_hat = a_hat * a_sh
            off *= 2
        g = d_acc + a_hat * carry[:, None]
        carry = a[:, 0] * g[:, 0]
        gB = (g * Bv[..., None]).sum(2)                        # [G, T, Dm]
        du.append(dt * gB + Dg[:, None] * dyc)
        g_ax = g * a * x_prev
        ddelta.append(sig * ((g_ax * Ag[:, None]).sum(2) + gB * uc))
        dB.append((g * (dt * uc)[:, :, None]).sum(3))          # [G, T, N]
        dC.append((dyc[:, :, None] * x).sum(3))
        dA_acc += (g_ax * dt[:, :, None]).sum(1)
    cat = lambda ts: torch.cat(ts[::-1], dim=1)[:, :L]
    du, ddelta, dB, dC = cat(du), cat(ddelta), cat(dB), cat(dC)
    dA, dD, dbias = _sum_partials(u, A, dA_acc, (dyf * uf).sum(1),
                                  ddelta.sum(1))
    return du, ddelta, dA, dB, dC, dD, dbias


def _check_T(T):
    if not isinstance(T, int) or T < 1:
        raise ValueError(f"chunk T must be a positive int, got {T!r}")


def bwd_smem_bytes(T: int, N: int) -> int:
    """Shared memory of the backward kernel's block at chunk T and state
    size N (csrc/selective_scan_v1_bwd.cu, smem_bytes)."""
    nmax = next(n for n in (8, 16, 32, 64) if N <= n)
    nsub = -(-T // 32)
    return 4 * (6 * 32 * (_WARPS + 1) + 2 * 32 * (nmax + 1) + _WARPS * nmax
                + 2 * _WARPS * 32 * (nmax + 1) + nsub * _WARPS * nmax)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd_cuda(u, delta, A, B, C, D, bias, T, want_xsave):
    """The forward kernel's wrapper: checks, allocates y (and xsave),
    launches csrc/selective_scan_v1_fwd.cu, counts the launch."""
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    K, _, N = A.shape
    _check_T(T)
    y = torch.empty_like(u)
    xsave = (torch.empty(G, -(-L // T), N, Dm, dtype=torch.float32,
                         device=u.device) if want_xsave else None)
    with torch.cuda.device(u.device):
        call(_FWD_KERNEL, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_void_p],
             [u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), D.data_ptr(), bias.data_ptr(), y.data_ptr(),
              None if xsave is None else xsave.data_ptr(),
              G, L, Dm, K, N, T, int(u.dtype == torch.bfloat16), _stream(u)])
    scan_v1_fwd.launches += 1
    return (y, xsave) if want_xsave else y


def scan_v1_fwd(u, delta, A, B, C, D, bias, T: int, want_xsave=False,
                impl: str = "auto"):
    """v1 forward at chunk T: y, or (y, xsave) with ``want_xsave``.
    ``impl`` as in ``scan_folded_fwd``: the CUDA kernel for CUDA tensors
    ("auto"/"cuda", which raises rather than fall back) or the plain
    version ("torch", or "auto" on the CPU).  A, D, bias fp32."""
    if resolve_impl(impl, u, "v1 scan") == "torch":
        return scan_v1_fwd_ref(u, delta, A, B, C, D, bias, T,
                               want_xsave=want_xsave)
    return _launch_fwd_cuda(u, delta, A, B, C, D, bias, T, want_xsave)


# Number of CUDA kernel launches so far; the wrapper adds one per launch,
# and nothing else changes it except a caller resetting it to 0.
scan_v1_fwd.launches = 0


def _launch_bwd_cuda(u, delta, A, B, C, D, bias, xsave, dy, T):
    """The backward kernel's wrapper: checks, allocates the outputs and
    the partials, launches csrc/selective_scan_v1_bwd.cu, counts the
    launch, sums the partials (dB and dC over the blocks' channel groups,
    dA, dD and dbias over the batch)."""
    _check_cuda_args(u, delta, A, B, C, D, bias)
    G, L, Dm = u.shape
    K, _, N = A.shape
    _check_T(T)
    for name, t, shape, dtype in (
            ("xsave", xsave, (G, -(-L // T), N, Dm), torch.float32),
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
    smem = bwd_smem_bytes(T, N)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"chunk T={T} at N={N} needs {smem} bytes of shared "
                         f"memory a block, over the card's {_SMEM_LIMIT}")
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty(G, L, Dm, **f32)
    ddelta = torch.empty_like(du)
    dB_part = torch.empty(-(-Dm // _WARPS), G, L, N, **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty(G, N, Dm, **f32)
    dD_part = torch.empty(G, Dm, **f32)
    dbias_part = torch.empty(G, Dm, **f32)
    ptrs = [t.data_ptr() for t in (u, delta, A, B, C, D, bias, xsave, dy, du,
                                   ddelta, dB_part, dC_part, dA_part, dD_part,
                                   dbias_part)]
    with torch.cuda.device(u.device):
        call(_BWD_KERNEL, [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
             + [ctypes.c_void_p],
             ptrs + [G, L, Dm, K, N, T, int(u.dtype == torch.bfloat16),
                     _stream(u)])
    scan_v1_bwd.launches += 1
    dA, dD, dbias = _sum_partials(u, A, dA_part, dD_part, dbias_part)
    return du, ddelta, dA, dB_part.sum(0), dC_part.sum(0), dD, dbias


def scan_v1_bwd(u, delta, A, B, C, D, bias, xsave, dy, T: int,
                impl: str = "auto"):
    """v1 backward at chunk T: (du, ddelta, dA, dB, dC, dD, dbias), all
    fp32, as ``bwd_folded`` returns them (``ScanFolded`` casts each to its
    input's dtype, as ``_cast_like`` does).  ``impl`` as in
    ``scan_v1_fwd``."""
    if resolve_impl(impl, u, "v1 scan") == "torch":
        return scan_v1_bwd_ref(u, delta, A, B, C, D, bias, xsave, dy, T)
    return _launch_bwd_cuda(u, delta, A, B, C, D, bias, xsave, dy, T)


# Number of CUDA kernel launches so far; as scan_v1_fwd.launches.
scan_v1_bwd.launches = 0
