"""The v1 selective scan (doubling scan inside chunks of T timesteps) in the
folded layout: the tile chooser, plain versions, CUDA kernel wrappers, and
plain twins of the kernels' decomposition.

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

The CUDA kernels (csrc/selective_scan_v1_{fwd,bwd}.cu) compute the same
functions another way: the forward walks each state through time
(``scan_v1_fwd_walk_ref``); the backward seeds each chunk from xsave,
walks it forward once to keep the state entering each piece of ``PIECE``
steps, then recomputes each piece and sweeps the adjoint back through it,
summing dB and dC over groups of 32 channels, then over the blocks of a
cluster (``scan_v1_bwd_pieces_ref``).  Only tests use these
twins; the plain versions above are what the CPU route runs and what the
kernels are held against on the card.
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
# the CUDA kernels' constants (csrc/selective_scan_v1_bwd.cu): states a
# thread, steps a piece of the backward's sweep, steps a staged window at
# most, blocks a cluster (the blocks whose dB/dC it adds)
STATES = 4
PIECE = 8
WIN_CAP = 56
CLUSTER = 8


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


def _nmax(N: int) -> int:
    """The kernels' template width for d_state N (8, 16, 32 or 64)."""
    return next(n for n in (8, 16, 32, 64) if N <= n)


def _sum_channels(v, Dm):
    """v [G, N, Dm] summed over the channels as the backward kernel adds
    them: within each group of 32 (a warp's lanes), then the groups in
    order (those of a block, the blocks of a cluster, the clusters); [G,
    N]."""
    G, N, _ = v.shape
    ngrp = -(-Dm // 32)
    per_group = F.pad(v, (0, 32 * ngrp - Dm)).reshape(G, N, ngrp, 32).sum(-1)
    return per_group.sum(-1)


def scan_v1_fwd_walk_ref(u, delta, A, B, C, D, bias, T: int):
    """The forward kernel's decomposition in plain PyTorch: every state
    walked through time in fp32, one step at a time (no doubling scan, no
    padding), the state stored as xsave where a chunk of T steps begins,
    y summed over the states.  Returns (y in u's dtype, xsave) as
    ``scan_v1_fwd_ref``."""
    G, L, Dm = u.shape
    N = A.shape[2]
    uf, df, Bf, Cf = (t.float() for t in (u, delta, B, C))
    Ag, Dg, bg = _per_seq(G, A.transpose(1, 2), D, bias)   # [G, N, Dm], ...
    dt = F.softplus(df + bg[:, None])                       # [G, L, Dm]
    x = torch.zeros(G, N, Dm, dtype=torch.float32, device=u.device)
    ys, xs = [], []
    for t in range(L):
        if t % T == 0:
            xs.append(x)
        x = torch.exp(dt[:, t, None] * Ag) * x \
            + (dt[:, t] * uf[:, t])[:, None] * Bf[:, t, :, None]
        ys.append((Cf[:, t, :, None] * x).sum(1) + uf[:, t] * Dg)
    return torch.stack(ys, 1).to(u.dtype), torch.stack(xs, 1)


def scan_v1_bwd_pieces_ref(u, delta, A, B, C, D, bias, xsave, dy, T: int):
    """The backward kernel's decomposition in plain PyTorch: the chunks in
    reverse, each seeded from the xsave it is given; a checkpoint walk from
    it keeps the state entering each piece of ``PIECE`` steps; the pieces
    last to first recompute their states and decays, then sweep the adjoint
    g_t = C_t dy_t + a_{t+1} g_{t+1} back through them, with the carry
    crossing pieces and chunks; dB and dC summed over the channels as the
    kernel adds them (``_sum_channels``).  Returns what ``scan_v1_bwd_ref``
    returns."""
    G, L, Dm = u.shape
    N = A.shape[2]
    uf, df, Bf, Cf, dyf = (t.float() for t in (u, delta, B, C, dy))
    Ag, Dg, bg = _per_seq(G, A.transpose(1, 2), D, bias)
    raw = df + bg[:, None]
    dt, sig = F.softplus(raw), torch.sigmoid(raw)           # [G, L, Dm]
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.zeros(G, L, Dm, **f32)
    ddelta = torch.zeros_like(du)
    dB = torch.zeros(G, L, N, **f32)
    dC = torch.zeros_like(dB)
    gc = torch.zeros(G, N, Dm, **f32)
    dA_acc = torch.zeros(G, N, Dm, **f32)

    def step(t, x):
        a = torch.exp(dt[:, t, None] * Ag)
        b = (dt[:, t] * uf[:, t])[:, None] * Bf[:, t, :, None]
        return a, a * x + b, b

    for t0 in reversed(range(0, L, T)):
        tl = min(T, L - t0)
        starts = list(range(t0, t0 + tl, PIECE))
        x = xsave[:, t0 // T].float()
        checkpoints = [x]
        for t in range(t0, starts[-1]):
            x = step(t, x)[1]
            if (t + 1 - t0) % PIECE == 0:
                checkpoints.append(x)
        for p in reversed(range(len(starts))):
            x = checkpoints[p]
            kept = []
            for t in range(starts[p], min(starts[p] + PIECE, t0 + tl)):
                a, x, b = step(t, x)
                kept.append((t, a, x, b))
            for t, a, x, b in reversed(kept):
                g = Cf[:, t, :, None] * dyf[:, t, None] + gc
                gax = g * (x - b)                           # g a_t x_{t-1}
                gB = (g * Bf[:, t, :, None]).sum(1)         # [G, Dm]
                du[:, t] = dt[:, t] * gB + Dg * dyf[:, t]
                ddelta[:, t] = sig[:, t] * ((gax * Ag).sum(1) + uf[:, t] * gB)
                dA_acc += gax * dt[:, t, None]
                dB[:, t] = _sum_channels(g * (dt[:, t] * uf[:, t])[:, None],
                                         Dm)
                dC[:, t] = _sum_channels(dyf[:, t, None] * x, Dm)
                gc = a * g
    dA, dD, dbias = _sum_partials(u, A, dA_acc, (dyf * uf).sum(1),
                                  ddelta.sum(1))
    return du, ddelta, dA, dB, dC, dD, dbias


def _check_T(T):
    if not isinstance(T, int) or T < 1:
        raise ValueError(f"chunk T must be a positive int, got {T!r}")


def _check_sizes(u, A):
    """Every size the C entries refuse below 1: L, Dm, N, K and G."""
    G, L, Dm = u.shape
    K, _, N = A.shape
    for name, v in (("G", G), ("L", L), ("Dm", Dm), ("K", K), ("N", N)):
        if v < 1:
            raise ValueError(f"{name}={v}: the v1 kernels need every size "
                             ">= 1")


def _groups(N: int) -> int:
    """Channel groups of 32 a block of the backward kernel: 3 at N <= 16,
    else 1 (``groups``)."""
    return 3 if _nmax(N) <= 16 else 1


def bwd_grid(Dm: int, N: int):
    """(blocks a sequence, clusters a sequence, threads a block) of the
    backward kernel (``cluster_shape``, ``bwd_threads``): blocks of 32
    ``_groups(N)`` channels, as few clusters of at most ``CLUSTER`` blocks
    as cover Dm, the blocks spread evenly over them."""
    nblk = -(-Dm // (32 * _groups(N)))
    nclus = -(-nblk // CLUSTER)
    return nclus * -(-nblk // nclus), nclus, \
        _groups(N) * _nmax(N) // STATES * 32


def bwd_clusters(Dm: int, N: int) -> int:
    """The dB and dC sums the backward writes a sequence, one a cluster:
    ceil(Dm / 768) at N <= 16, ceil(Dm / 256) above."""
    return bwd_grid(Dm, N)[1]


def bwd_ckpt_floats(G: int, Dm: int, N: int, T: int) -> int:
    """fp32 values of the backward's checkpoint scratch: a float4 a thread
    and piece of a chunk, for every block."""
    blocks, _, threads = bwd_grid(Dm, N)
    return G * blocks * -(-T // PIECE) * threads * STATES


def _pass_info(name: str, args) -> dict:
    from medical_image_classification_tpu_torch.kernels import _build
    lib = _build.library(name)
    fn = getattr(lib, f"{name}_pass_info")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.raise_on_error(lib, name, fn(*args, ctypes.addressof(out)))
    return {"walk": tuple(out)}


def fwd_pass_info(N: int, dtype) -> dict:
    """What the card grants the forward kernel's one pass at d_state N and
    operand type ``dtype``: {"walk": (registers a thread, local-memory
    bytes a thread (spills), shared bytes a block, resident warps per
    SM)}."""
    return _pass_info(_FWD_KERNEL, (N, int(dtype == torch.bfloat16)))


def bwd_pass_info(N: int, dtype, T: int) -> dict:
    """``fwd_pass_info`` for the backward kernel's one pass at chunk T (its
    shared memory grows with T)."""
    return _pass_info(_BWD_KERNEL, (N, T, int(dtype == torch.bfloat16)))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd_cuda(u, delta, A, B, C, D, bias, T, want_xsave):
    """The forward kernel's wrapper: checks, allocates y (and xsave),
    launches csrc/selective_scan_v1_fwd.cu, counts the launch."""
    _check_sizes(u, A)
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
    """The backward kernel's wrapper: checks, allocates the outputs (dB and
    dC as ``bwd_clusters`` sums, added here in order where there are more
    than one), the per-sequence partials and the checkpoint scratch,
    launches csrc/selective_scan_v1_bwd.cu, counts the launch, sums dA, dD
    and dbias over the batch."""
    _check_sizes(u, A)
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
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty(G, L, Dm, **f32)
    ddelta = torch.empty_like(du)
    dB_part = torch.empty(bwd_clusters(Dm, N), G, L, N, **f32)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty(G, N, Dm, **f32)
    dD_part = torch.empty(G, Dm, **f32)
    dbias_part = torch.empty(G, Dm, **f32)
    ckpt = torch.empty(bwd_ckpt_floats(G, Dm, N, T), **f32)
    ptrs = [t.data_ptr() for t in (u, delta, A, B, C, D, bias, xsave, dy, du,
                                   ddelta, dB_part, dC_part, dA_part, dD_part,
                                   dbias_part, ckpt)]
    with torch.cuda.device(u.device):
        call(_BWD_KERNEL, [ctypes.c_void_p] * 17 + [ctypes.c_longlong]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p],
             ptrs + [ckpt.numel(), G, L, Dm, K, N, T,
                     int(u.dtype == torch.bfloat16), _stream(u)])
    scan_v1_bwd.launches += 1
    dA, dD, dbias = _sum_partials(u, A, dA_part, dD_part, dbias_part)
    sums = [p[0] if len(p) == 1 else p.sum(0) for p in (dB_part, dC_part)]
    return (du, ddelta, dA, *sums, dD, dbias)


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
