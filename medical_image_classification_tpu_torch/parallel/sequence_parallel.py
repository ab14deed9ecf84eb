"""Sequence-parallel (L-sharded) scans over a mesh axis.

Port of ``medical_image_classification_tpu/parallel/sequence_parallel.py``.
Each rank scans its L-shard, the per-shard (decay, final-state) summaries
are exchanged with one small all-gather, every rank computes its incoming
state by a prefix combine over the shards before it, and the scan is
completed from that state:

* ``ssd_sequence_parallel`` — exact, one extra einsum: the SSD decay is a
  scalar per head, so exp(cumsum(dt A)) is only [B, L, H] and the
  cross-shard term is a Y_off-style correction.
* ``selective_scan_sequence_parallel`` — two passes on the folded scan
  kernels (rows 1-2): pass 1 from a zero state for the summary
  (``want_state``), pass 2 again seeded with the incoming state
  (``init``), because the Mamba-1 per-(d, n) decay cannot be
  materialised.  Their backward takes ``dlast`` and gives ``dinit``.

Both take the local shard (as the JAX functions do inside ``shard_map``);
``scan_sequence_parallel`` and ``ssd_scan_sequence_parallel`` are the
``shard_map``: they cut the replicated operands into shards, sum the
replicated parameters' gradients over the axis and gather the output.
A, the summaries and the carried state are fp32; bf16 stays on the
operands.  The collectives are ``parallel/collectives.py``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.selective_scan_fwd import (
    scan_folded_fwd,
)
from medical_image_classification_tpu_torch.kernels.ssd import ssd_chunked
from medical_image_classification_tpu_torch.parallel.collectives import (
    gather_pieces,
    reduce_grad,
    shard,
    unshard,
)


def _incoming_state(a_total, last_state, axis):
    """This rank's incoming state from every shard's summary.

    a_total: decay across the whole local shard (broadcastable against
    ``last_state``); last_state: the local final state from a zero incoming
    state.  Gathers [size, ...] summaries and prefix-combines them.  Every
    rank builds the whole stack and keeps its own row, so that each rank's
    result depends on the gathered summaries (rank 0's row is zeros) and
    every rank runs the gather's backward."""
    a_all = gather_pieces(a_total, axis)                 # [size, ...]
    s_all = gather_pieces(last_state, axis)
    incoming = [torch.zeros_like(last_state)]            # for rank 0
    run = s_all[0]
    for i in range(1, axis.size):
        incoming.append(run)
        run = a_all[i] * run + s_all[i]
    return torch.stack(incoming)[axis.index]


def check_divisible(L: int, axis) -> None:
    """``ValueError`` unless the sequence splits evenly over the axis (the
    JAX ``shard_map``'s "not evenly divisible")."""
    if L % axis.size:
        raise ValueError(f"sequence length {L} is not evenly divisible by "
                         f"the seq axis size {axis.size}")


def ssd_sequence_parallel(x, dt, A, B, C, axis, chunk_size: int = 128,
                          D=None, dt_bias=None, impl: str = "auto"):
    """Exact L-sharded SSD scan: shapes as ``ssd_chunked``, L the local
    shard; the step is softplus(dt + dt_bias).  Returns y in x's dtype."""
    f32 = torch.float32
    y_local, s_final = ssd_chunked(x, dt, A, B, C, chunk_size, None, dt_bias,
                                   impl=impl, return_final_state=True)
    dtc = dt.to(f32)
    if dt_bias is not None:
        dtc = dtc + dt_bias.to(f32)
    dtA = F.softplus(dtc) * A.to(f32)                    # [B, L, H]
    a_total = torch.exp(dtA.sum(1))[..., None, None]     # [B, H, 1, 1]
    s_in = _incoming_state(a_total, s_final, axis)       # [B, H, P, N]

    # cross-shard correction: y_t += C_t . (exp(cumsum dtA)_t * s_in)
    rep = x.shape[2] // B.shape[2]
    Ch = C.to(f32).repeat_interleave(rep, dim=2)         # [B, L, H, N]
    decay = torch.exp(torch.cumsum(dtA, dim=1))          # [B, L, H]
    y_corr = torch.einsum("blhn,bhpn,blh->blhp", Ch, s_in, decay)
    y = y_local.to(f32) + y_corr
    if D is not None:
        y = y + x.to(f32) * (D.to(f32)[None, None, :, None] if D.dim() == 1
                             else D.to(f32))
    return y.to(x.dtype)


def selective_scan_sequence_parallel(u, delta, A, B, C, D, bias, axis,
                                     impl: str = "auto"):
    """L-sharded Mamba-1 scan in the folded layout (``scan_folded_fwd``'s
    shapes, L the local shard; softplus on the step): pass 1 scans from a
    zero state for the shard's final state, pass 2 rescans from the
    incoming state.  Returns y in u's dtype."""
    f32 = torch.float32
    G, L, Dm = u.shape
    K = A.shape[0]
    _, s_final = scan_folded_fwd(u, delta, A, B, C, D, bias, impl=impl,
                                 want_state=True)        # [G, N, Dm] fp32
    Ag = A.to(f32).repeat(G // K, 1, 1)                  # [G, Dm, N]
    bg = bias.to(f32).repeat(G // K, 1)                  # [G, Dm]
    dtc = F.softplus(delta.to(f32) + bg[:, None])
    # whole-shard decay per (n, d): exp(sum_t dt_t * A)
    a_total = torch.exp(dtc.sum(1)[:, None, :] * Ag.transpose(1, 2))
    s_in = _incoming_state(a_total, s_final, axis)
    return scan_folded_fwd(u, delta, A, B, C, D, bias, impl=impl,
                           init=s_in.contiguous())


def scan_sequence_parallel(u, delta, A, B, C, D, bias, axis,
                           impl: str = "auto"):
    """The folded scan over full-length replicated operands u, delta, B, C
    [G, L, *], L-sharded over ``axis``: each rank scans its shard (two
    passes), the output is gathered back to [G, L, Dm] on every rank.
    Raises ``ValueError`` before any launch where L does not split
    evenly."""
    check_divisible(u.shape[1], axis)
    A, D, bias = (reduce_grad(t, axis) for t in (A, D, bias))
    u, delta, B, C = (shard(t, 1, axis) for t in (u, delta, B, C))
    y = selective_scan_sequence_parallel(u, delta, A, B, C, D, bias, axis,
                                         impl=impl)
    return unshard(y, 1, axis)


def ssd_scan_sequence_parallel(x, dt, A, B, C, chunk_size, D, dt_bias, axis,
                               impl: str = "auto"):
    """``ssd_chunked`` over full-length replicated x [B, L, H, P], dt
    [B, L, H], B, C [B, L, G, N], L-sharded over ``axis``; returns the
    gathered y [B, L, H, P].  Raises ``ValueError`` before any launch where
    L does not split evenly."""
    check_divisible(x.shape[1], axis)
    A, D, dt_bias = (reduce_grad(t, axis) for t in (A, D, dt_bias))
    x, dt, B, C = (shard(t, 1, axis) for t in (x, dt, B, C))
    y = ssd_sequence_parallel(x, dt, A, B, C, axis, chunk_size=chunk_size,
                              D=D, dt_bias=dt_bias, impl=impl)
    return unshard(y, 1, axis)
