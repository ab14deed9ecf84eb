"""The collectives of data, sequence and tensor parallelism, with their
gradients.

Port-only: the JAX package writes ``lax.all_gather`` / ``psum`` inside a
``shard_map`` and lets JAX transpose them; here each is a
``torch.autograd.Function`` over one mesh axis (``parallel/mesh.py``'s
``Axis``).  Every one is built on ``all_reduce`` alone, the collective
gloo takes on CUDA tensors as NCCL does (so ranks that share one card run
them over gloo): an all-gather is an all_reduce of a zero-filled buffer in
which each rank has written its own slot.  An axis of one rank
communicates nothing.

Under sequence parallelism the model is replicated across the seq ranks
and only the scan is L-sharded, so every rank's loss is the same loss:

* ``gather_pieces``  — all-gather of the shard summaries; its backward
  hands each rank the sum over ranks of the cotangents of its own piece
  (each rank's summary feeds every later rank's incoming state).
* ``shard``          — slice forward, all-reduce backward: a replicated
  input of the scan, each rank keeping its L-shard; the backward assembles
  the full gradient on every rank.
* ``unshard``        — all-gather forward, slice backward: the scan's
  output, replicated again; every rank's cotangent is the full one, so
  each keeps its own slice of it.
* ``reduce_grad``    — identity forward, all-reduce backward: a replicated
  parameter used inside the sharded region, whose gradient is the sum of
  the ranks' parts.
* ``all_reduce_sum`` — sum forward, sum backward: BatchNorm's statistics
  over the data axis, whose backward sums every rank's cotangent of the
  global statistics; under tensor parallelism, the sums over the model
  axis that feed rank-local work again (``x_proj``'s partial products,
  the statistics of the norms over sharded channels).
* ``reduce_out``     — sum forward, identity backward: the row-parallel
  out-projection's partial outputs leaving a tensor-parallel region, whose
  sum feeds replicated work, so every rank's cotangent is already the full
  one.

A tensor-parallel layer (``models/ss2d_modules.py``) enters its region
through ``reduce_grad`` (its input is replicated, each rank's part of the
input's gradient flows back from its own channels) and leaves it through
``reduce_out``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# gloo's reductions take fp32 and fp64 (and integer) tensors on every
# build; other float types ride in fp32, which is exact for the sums of
# zeros and one value that the gathers make
_WIDE = (torch.float32, torch.float64)


def all_reduce_(t: torch.Tensor, axis) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (a fresh tensor where the dtype is
    widened for the wire); returns the sum."""
    if axis.size == 1:
        return t
    if t.dtype in _WIDE:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
        return t
    w = t.float()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=axis.group)
    return t.copy_(w)


def all_gather(t: torch.Tensor, axis) -> torch.Tensor:
    """[size, *t.shape]: every rank's ``t`` in its slot, on every rank (no
    autograd)."""
    buf = t.new_zeros((axis.size,) + tuple(t.shape))
    buf[axis.index] = t
    return all_reduce_(buf, axis)


class _GatherPieces(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis)[ctx.axis.index], \
            None


def gather_pieces(t, axis):
    """[size, *t.shape] of every rank's ``t``; the backward sums each
    piece's cotangent over the ranks and hands it to the piece's rank."""
    return _GatherPieces.apply(t, axis)


def _piece(t, dim, axis):
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis, ctx.shape = dim, axis, t.shape
        return _piece(t, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        _piece(full, ctx.dim, ctx.axis).copy_(g)
        return all_reduce_(full, ctx.axis), None, None


def shard(t, dim, axis):
    """This rank's contiguous piece of ``t`` along ``dim`` (the rank's index
    along ``axis`` orders the pieces); the backward all-reduces the
    zero-padded piece gradients into the full gradient."""
    if t.shape[dim] % axis.size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide by the axis size {axis.size}")
    return _Shard.apply(t, dim, axis)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        stack = all_gather(t.contiguous(), axis)     # [size, ...]
        return torch.cat(stack.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.dim, ctx.axis).contiguous(), None, None


def unshard(t, dim, axis):
    """The pieces of every rank concatenated along ``dim`` in rank order;
    the backward keeps this rank's piece of the (replicated) cotangent."""
    return _Unshard.apply(t, dim, axis)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def reduce_grad(t, axis):
    """``t`` itself; its gradient is summed over ``axis``."""
    return _ReduceGrad.apply(t, axis)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return all_reduce_(t.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def all_reduce_sum(t, axis):
    """The sum of ``t`` over ``axis`` on every rank; its backward is the
    same sum of the cotangents."""
    return _AllReduceSum.apply(t, axis)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce_(t.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_out(t, axis):
    """The sum of ``t`` over ``axis`` on every rank; its backward hands
    the cotangent on as it is."""
    return _ReduceOut.apply(t, axis)
