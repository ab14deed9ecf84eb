"""Chunked SSD scan (Mamba-2 / state-space duality) in PyTorch.

Port of ``medical_image_classification_tpu/kernels/ssd.py``:
``_pick_chunk`` (kept identical, so both packages pick the same chunks),
``ssd_dirs_chunk`` (the gate of the four-direction fused path, without the
TPU-only terms), ``ssd_chunked_dirs`` (the dt rows of that path, then
``kernels/ssd_fused_dirs.py``), ``ssd_chunked`` (the einsum path with
padding and the unrolled chunk walk, taken where the fused dirs path is
not; where ``ssd_fused_supported`` takes the chunk the whole SSD goes to
``kernels/ssd_fused.py``, else its intra-chunk Y_diag to
``kernels/ssd_ydiag.py`` where that gate says so, in the JAX package's
order) and ``ssd_seq_ref`` (the golden per-token recurrence).  The
cumsum is ``torch.cumsum`` and reversals are index flips: the
triangular-ones and anti-identity matmuls of the JAX module were TPU
workarounds.

Shapes (Mamba-2 convention):
  x  : [B, L, H, P]   (H heads, P headdim)
  dt : [B, L, H]
  A  : [H]            (negative)
  B,C: [B, L, G, N]   (G groups, broadcast over H // G heads)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.ssd_fused import (
    MAX_N as _CARD_MAX_N,
    PT as _CARD_TILE,
    ssd_fused,
    ssd_fused_supported,
)
from medical_image_classification_tpu_torch.kernels.ssd_fused_dirs import (
    ssd_fused_dirs,
)
from medical_image_classification_tpu_torch.kernels.ssd_ydiag import (
    ydiag_fused,
    ydiag_supported,
)

# The fused four-direction path's chunk window and shape terms.  Module
# constants so that tests can widen the window to small shapes, as the JAX
# package's tests patch its kernel module.
_MIN_L = 196
_MAX_L = 256


def _pick_chunk(L: int, chunk_size: int, N: int = 512) -> int:
    """Padding-aware effective chunk size, the JAX package's rule: for a
    large state (N >= 256) one 8-aligned chunk when L <= 3.5 x chunk_size,
    else the largest 8-stepped pad-free divisor in [7/8 chunk_size,
    chunk_size]; for a small state the largest pad-free divisor in
    [96, min(chunk_size, 256)]."""
    if N >= 256:
        if 2 * L <= 7 * chunk_size:
            return -(-L // 8) * 8                   # one chunk, 8-aligned
        for c in range(chunk_size, (7 * chunk_size) // 8 - 1, -8):
            if L % c == 0:
                return c
        return chunk_size
    if L <= max(chunk_size, 256):
        return -(-L // 8) * 8                       # one chunk, 8-aligned
    for c in range(min(chunk_size, 256), 95, -1):   # largest pad-free divisor
        if L % c == 0:
            return c
    return chunk_size


def dirs_supported(l: int, N: int, P: int, nc: int, H4: int,
                   d_ssm: int, card: bool = False) -> bool:
    """Shape terms of the four-direction fused path (``N`` = 4 * gn, the
    coupled state width): pad-free chunks (checked by the caller), at
    least two of them (the mirrored-chunk maps), l inside the window,
    B/C slabs at whole multiples of gn in the role-major stack, and
    d_ssm = nheads * P.  ``card``: the operands lie on the GPU, where the
    CUDA kernels also need P and N to be multiples of 32 (``_CARD_TILE``)
    and N <= 512; elsewhere the plain version takes any of these shapes."""
    if H4 % 4 or N % 4 or l % 4 or P % 8:
        return False
    if card and (P % _CARD_TILE or N % _CARD_TILE or N > _CARD_MAX_N):
        return False
    gn = N // 4
    if d_ssm % gn or d_ssm != (H4 // 4) * P:
        return False
    return nc >= 2 and _MIN_L <= l <= _MAX_L


def ssd_dirs_chunk(L: int, chunk_size: int, N: int, P: int, H4: int,
                   d_ssm: int, card: bool = False):
    """Chunk size for the four-direction fused path, or None (the caller
    then takes ``ssd_chunked``).  The chunk must be pad-free: the direction
    mirroring maps chunk c to nc - 1 - c."""
    c = _pick_chunk(L, chunk_size, N)
    if L % c == 0 and dirs_supported(c, N, P, L // c, H4, d_ssm, card):
        return c
    for c in range(min(chunk_size, _MAX_L), _MIN_L - 1, -4):
        if L % c == 0 and dirs_supported(c, N, P, L // c, H4, d_ssm, card):
            return c
    return None


def ssd_chunked_dirs(stackr, A, D, dt_bias, chunk_size: int, *, d_ssm: int,
                     gn: int, nheads: int, headdim: int, impl: str = "auto"):
    """Four-direction folded SSD from the d0/d1 stack's bytes only.

    stackr : [B, L, 2 C'] role-major d0|d1 stack (channel runs
             [x_j0|x_j1|B_j0|B_j1|C_j0|C_j1|dt_j0|dt_j1], C' = d_ssm + 2 gn
             + nheads, from ``ops/cross_scan.py::
             cross_scan_time_major2_roles``); directions 2/3 are sequence
             flips of 0/1 and are never materialised.
    A, D, dt_bias : [4 nheads] per-direction parameters (D per head); the
             step is softplus(dt + dt_bias), as every model uses it.
    impl   : the fused kernel's implementation, see
             ``kernels/ssd_fused_dirs.py::ssd_fused_dirs``.

    Returns y [B, L, 4 nheads, P] with directions 2/3 already in d0/d1
    order (merge with ``cross_merge_noflip_time_major``).  The caller has
    checked the shape with ``ssd_dirs_chunk``.
    """
    out_dtype = stackr.dtype
    Bsz, L, C2c = stackr.shape
    H2, H4, P = 2 * nheads, 4 * nheads, headdim
    if L % chunk_size:
        raise ValueError("the dirs path needs pad-free chunks")
    l = chunk_size
    nc = L // l
    stackc = stackr.reshape(Bsz, nc, l, C2c)

    # dt rows [B, nc, H2, l]; directions 2/3 read chunk nc - 1 - c reversed
    dt2 = stackr[..., 2 * (d_ssm + 2 * gn):]
    dtT_f = dt2.reshape(Bsz, nc, l, H2).transpose(2, 3).float()
    dtT_r = dtT_f.flip(1).flip(3)
    dtT = torch.cat([dtT_f, dtT_r], dim=2)                  # [B, nc, H4, l]
    dtT = F.softplus(dtT + dt_bias.float()[:, None])
    A_cum = torch.cumsum(dtT * A.float()[:, None], dim=-1)
    dte = torch.exp(A_cum[..., -1:] - A_cum)
    cdec = torch.exp(A_cum[..., -1])
    y = ssd_fused_dirs(stackc, A_cum, dte, cdec, dtT, D, d_ssm, gn,
                       impl=impl)                           # [B, nc, l, H4 P]
    return y.reshape(Bsz, L, H4, P).to(out_dtype)


def ssd_chunked(x, dt, A, B, C, chunk_size: int, D, dt_bias,
                impl: str = "auto"):
    """Chunked block-matmul SSD scan (the JAX package's einsum path, with
    the models' settings: the step is softplus(dt + dt_bias), the chunk is
    ``_pick_chunk``'s, the scan starts from a zero state and adds the D
    skip):
      1. intra-chunk outputs   : Y_diag = (C B^T * decay) X
      2. chunk states          : S_c    = B^T (decay_to_end * X)
      3. inter-chunk recurrence: S_c'   = exp(sum dtA_c) S_{c-1}' + S_c
      4. state contribution    : Y_off  = C S_in * decay_from_start
    Matmul operands are in x's dtype with the same outputs as the JAX
    einsums (the chunk states accumulate in fp32); dt, the cumsums and the
    carried state are fp32.  D is [H].  The gates decide from the shapes
    (and, for a CUDA tensor, the CUDA kernels' limits), in the JAX
    package's order:
      - ``ssd_fused_supported``: steps 1-4 are ``ssd_fused`` (the CUDA
        kernels by ``impl``, forward and, under autograd, backward; see
        ``kernels/ssd_fused.py``) over the padded chunks, x flat and
        l-major; autograd chains its dte and cdec cotangents to the cumsum;
      - else ``ydiag_supported``: Y_diag is ``ydiag_fused`` (see
        ``kernels/ssd_ydiag.py``), whose gradient reaches dt, dt_bias and A
        through dacum; it rounds M = scores x decay once where the einsum
        rounds the scores and the decay each;
      - else the einsums."""
    mm = x.dtype
    f32 = torch.float32
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G

    dt = F.softplus(dt.to(f32) + dt_bias.to(f32))
    chunk_size = _pick_chunk(L, chunk_size, N)
    pad = (-L) % chunk_size
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc, l = Lp // chunk_size, chunk_size

    xc = x.reshape(Bsz, nc, l, H, P)
    dtc = dt.reshape(Bsz, nc, l, H)
    Bc = B.reshape(Bsz, nc, l, G, N)
    Cc = C.reshape(Bsz, nc, l, G, N)

    A_cum_t = torch.cumsum((dtc * A.to(f32)).transpose(2, 3), dim=-1)
    A_cum = A_cum_t.transpose(2, 3)                         # [B, nc, l, H]
    xs = x.reshape(Bsz, Lp, H, P)[:, :L]
    D_skip = xs * D.to(mm)[None, None, :, None]

    if ssd_fused_supported(l, N, P, G, nc, card=x.is_cuda, batch=Bsz,
                           dtype=mm):
        dte = torch.exp(A_cum_t[..., -1:] - A_cum_t)        # [B, nc, H, l]
        cdec = torch.exp(A_cum_t[..., -1])                  # [B, nc, H]
        y = ssd_fused(Cc.to(mm).reshape(Bsz, nc, l, N),
                      Bc.to(mm).reshape(Bsz, nc, l, N), A_cum_t, dte, cdec,
                      dtc.transpose(2, 3), x.reshape(Bsz, nc, l, H * P),
                      impl=impl)
        return y.reshape(Bsz, Lp, H, P)[:, :L] + D_skip

    dtx_r = (xc * dtc.to(mm)[..., None]).reshape(Bsz, nc, l, G, rep, P)
    dtx_h = dtx_r.movedim(2, 4)                             # [B,nc,G,r,l,P]
    Bc_h = Bc.movedim(2, 3).to(mm)                          # [B,nc,G,l,N]

    # 1. intra-chunk: scores once per group, modulated per head
    if ydiag_supported(l, N, P, G, card=x.is_cuda, BC=Bsz * nc, dtype=mm):
        BC = Bsz * nc
        Ydh = ydiag_fused(Cc.to(mm).reshape(BC, l, N),
                          Bc.to(mm).reshape(BC, l, N),
                          A_cum_t.reshape(BC, H, l),
                          dtx_h.reshape(BC, H, l, P), impl=impl)
        Y_diag = Ydh.reshape(Bsz, nc, H, l, P).transpose(2, 3)
    else:
        seg = A_cum_t[..., :, None] - A_cum_t[..., None, :]
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        Lmat = torch.exp(seg.masked_fill(~causal, float("-inf"))).to(mm)
        Lmat_r = Lmat.reshape(Bsz, nc, G, rep, l, l)
        scores = torch.einsum("bclgn,bcsgn->bcgls", Cc.to(mm), Bc.to(mm))
        M = scores[:, :, :, None] * Lmat_r
        Y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", M, dtx_r)
        Y_diag = Y_diag.reshape(Bsz, nc, l, H, P)

    # 2. per-chunk end states, fp32 accumulation
    decay_to_end_t = torch.exp(A_cum_t[..., -1:] - A_cum_t).to(mm)
    dtx_d_h = dtx_h * decay_to_end_t.reshape(Bsz, nc, G, rep, l)[..., None]
    S = torch.einsum("bcgln,bcgrlp->bcgrpn", Bc_h.to(f32), dtx_d_h.to(f32))

    chunk_decay = torch.exp(A_cum[:, :, -1, :])             # [B, nc, H]
    decay_from_start = torch.exp(A_cum).to(mm)              # [B, nc, l, H]

    # 3+4. the unrolled inter-chunk walk; incoming states staged in mm
    S_carry = torch.zeros(Bsz, G, rep, P, N, dtype=f32, device=x.device)
    S_ins = []
    for c in range(nc):
        S_ins.append(S_carry.to(mm))
        S_carry = (chunk_decay[:, c].reshape(Bsz, G, rep, 1, 1) * S_carry
                   + S[:, c])
    S_in = torch.stack(S_ins, dim=1)                        # [B,nc,G,r,P,N]
    Y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc.to(mm), S_in)
    Y_off = Y_off.reshape(Bsz, nc, l, H, P) * decay_from_start[..., None]

    y = (Y_diag + Y_off).reshape(Bsz, Lp, H, P)[:, :L]
    return y + D_skip


def ssd_seq_ref(x, dt, A, B, C, D=None, z=None, dt_bias=None,
                dt_softplus: bool = True, initial_state=None,
                return_final_state: bool = False):
    """Golden sequential reference (per-token recurrence, fp32)."""
    f32 = torch.float32
    out_dtype = x.dtype
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    dt = dt.to(f32)
    if dt_bias is not None:
        dt = dt + dt_bias.to(f32)
    if dt_softplus:
        dt = F.softplus(dt)
    Bh = B.repeat_interleave(rep, dim=2).to(f32)
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    s = (torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t] * A.to(f32))                 # [B, H]
        s = dA[..., None, None] * s + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].to(f32) * dt[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + x.to(f32) * (D.to(f32)[None, None, :, None] if D.dim() == 1
                             else D.to(f32))
    if z is not None:
        y = y * F.silu(z.to(f32))
    y = y.to(out_dtype)
    if return_final_state:
        return y, s.to(out_dtype)
    return y
