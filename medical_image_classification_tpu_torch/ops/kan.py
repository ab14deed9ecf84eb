"""Kolmogorov-Arnold (KAN) B-spline ops in PyTorch.

Port of ``medical_image_classification_tpu/ops/kan.py``: the efficient-KAN
core (``make_grid``, ``extend_grid``, ``b_splines``, ``curve2coeff``,
``kan_linear``, ``kan_update_grid``) and the original-pykan ("o-KAN") core
(``coef2curve``, ``okan_curve2coef``, ``sparse_mask``, ``okan_forward``,
``okan_update_grid``), and the helpers no model calls:
``kan_regularization``, ``okan_forward``'s ``return_acts``,
``okan_get_subset``, ``okan_swap`` and ``okan_refine_grid``.  Plain
PyTorch: the JAX functions are XLA code, not Pallas kernels, and the
spline contractions here are one matmul each over [batch, in x coeff],
never a [batch, out, in, coeff] broadcast.

The re-gridding functions pick sample indices with the JAX package's
float32 formulas (``_linspace_f32``, ``_okan_ids``), so that both packages
take the same samples as knots (and ``okan_refine_grid`` the same knots);
``torch.linspace`` rounds otherwise and can land one index off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32, the same bits as XLA
    on the CPU computes it: with r = 1 / (num - 1) and i = iota,
    start (1 - i r) + i (stop r), the last product and sum fused (one
    rounding), the end point appended exactly."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    r = f32(1.0) / f32(float(num - 1))
    i = torch.arange(num - 1, dtype=torch.float32)
    head = f32(start) * (1 - i * r)
    tail = i.double() * (f32(stop) * r).double()
    return torch.cat([(head.double() + tail).float(), f32(stop)[None]])


def _okan_ids(batch: int, num: int) -> torch.Tensor:
    """The o-KAN knot samples: (batch / num * arange(num)) truncated, the
    product in float32 as JAX takes it, then batch - 1."""
    step = torch.tensor(batch / num, dtype=torch.float32)
    ids = (step * torch.arange(num, dtype=torch.float32)).to(torch.int64)
    return torch.cat([ids, torch.tensor([batch - 1])])


def make_grid(in_features: int, grid_size: int, spline_order: int,
              grid_range=(-1.0, 1.0)):
    """Uniform extended grid: [in_features, grid_size + 2 spline_order + 1]."""
    h = (grid_range[1] - grid_range[0]) / grid_size
    pts = (torch.arange(-spline_order, grid_size + spline_order + 1,
                        dtype=torch.float32) * h + grid_range[0])
    return pts.expand(in_features, pts.shape[0]).contiguous()


def extend_grid(grid, k: int):
    """Extend a [in, G + 1] grid by k steps on both sides (o-KAN)."""
    h = (grid[:, -1:] - grid[:, :1]) / (grid.shape[1] - 1)
    steps = torch.arange(k, 0, -1, dtype=grid.dtype, device=grid.device)
    left = grid[:, :1] - h * steps
    right = grid[:, -1:] + h * torch.arange(1, k + 1, dtype=grid.dtype,
                                            device=grid.device)
    return torch.cat([left, grid, right], dim=1)


def b_splines(x, grid, spline_order: int):
    """B-spline bases by Cox-de Boor over the order.

    x [batch, in], grid [in, n_pts] -> [batch, in, n_pts - 1 - order]."""
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, :-(k + 1)]) / (grid[:, k:-1] - grid[:, :-(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def curve2coeff(x, y, grid, spline_order: int, ridge: float = 1e-8):
    """Spline coefficients through (x, y) by a ridge normal-equation solve,
    the ridge scaled with the trace of AᵀA.

    x [batch, in], y [batch, in, out] -> [out, in, coeff]."""
    A = b_splines(x, grid, spline_order).transpose(0, 1)    # [in, b, coeff]
    Bm = y.transpose(0, 1)                                   # [in, b, out]
    AtA = A.transpose(1, 2) @ A
    AtB = A.transpose(1, 2) @ Bm
    n = AtA.shape[-1]
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None] / n
    lam = ridge + 1e-6 * tr + 1e-8
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    sol = torch.linalg.solve(AtA + lam * eye, AtB)
    return sol.permute(2, 0, 1)


def _spline_matmul(bases, w):
    """sum_{i,c} bases[b, i, c] w[o, i, c] as one matmul -> [b, o]."""
    return bases.reshape(bases.shape[0], -1) @ w.reshape(w.shape[0], -1).t()


def kan_linear(x, grid, base_weight, spline_weight, spline_scaler,
               spline_order: int):
    """Efficient-KAN forward in fp32, returned in x's dtype:
    silu(x) W_baseᵀ + B-splines(x) · (W_spline · scaler).

    x [..., in]; base_weight [out, in]; spline_weight [out, in, coeff];
    spline_scaler [out, in] or None."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).float()
    base = F.silu(x2) @ base_weight.t()
    w = spline_weight
    if spline_scaler is not None:
        w = w * spline_scaler[..., None]
    out = base + _spline_matmul(b_splines(x2, grid, spline_order), w)
    return out.to(x.dtype).reshape(shape[:-1] + (base_weight.shape[0],))


def kan_update_grid(x, grid, spline_weight, spline_scaler, *,
                    grid_size: int, spline_order: int, grid_eps: float = 0.02,
                    margin: float = 0.01):
    """Re-grid from the sample quantiles of x [batch, in] and refit the
    spline weights to keep the layer's function.  Returns (new_grid,
    new_spline_weight)."""
    batch = x.shape[0]
    w = spline_weight
    if spline_scaler is not None:
        w = w * spline_scaler[..., None]
    # the current spline outputs per (batch, in, out)
    unreduced = torch.einsum("bic,oic->bio",
                             b_splines(x, grid, spline_order), w)
    x_sorted = torch.sort(x, dim=0).values
    idx = _linspace_f32(0.0, batch - 1.0, grid_size + 1).to(torch.int64)
    grid_adaptive = x_sorted[idx.to(x.device)]               # [G + 1, in]
    step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / grid_size
    iota = lambda n: torch.arange(n, dtype=torch.float32, device=x.device)
    grid_uniform = iota(grid_size + 1)[:, None] * step + x_sorted[0] - margin
    g = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    # strictly increasing knots from a batch with repeated samples
    g = torch.cummax(g, dim=0).values
    span = torch.clamp(g[-1] - g[0], min=1e-3)
    g = g + iota(g.shape[0])[:, None] * 1e-4 * span
    step = torch.maximum(step, 1e-4 * span)
    lo = g[:1] - step * iota(spline_order + 1)[1:].flip(0)[:, None]
    hi = g[-1:] + step * iota(spline_order + 1)[1:][:, None]
    new_grid = torch.cat([lo, g, hi], dim=0).t().contiguous()
    new_w = curve2coeff(x, unreduced, new_grid, spline_order)
    if spline_scaler is not None:
        sc = spline_scaler[..., None]
        safe = torch.where(sc.abs() > 1e-3, sc,
                           torch.where(sc >= 0, 1e-3, -1e-3))
        new_w = new_w / safe
    return new_grid, new_w


def kan_regularization(spline_weight, regularize_activation: float = 1.0,
                       regularize_entropy: float = 1.0):
    """The e-KAN regulariser over spline weights [out, in, coeff]: the sum
    of the mean |w| of each edge (L1), plus the entropy of those means
    normalised to a distribution, each by its factor."""
    l1 = spline_weight.abs().mean(-1)
    act = l1.sum()
    p = l1 / (act + 1e-12)
    ent = -(p * torch.log(p + 1e-12)).sum()
    return regularize_activation * act + regularize_entropy * ent


def coef2curve(x, grid, coef, k: int):
    """Per-edge splines: x [batch, in], coef [in, out, coeff] ->
    [batch, in, out]."""
    return torch.einsum("bic,ioc->bio", b_splines(x, grid, k), coef)


def okan_curve2coef(x, y, grid, k: int, lamb: float = 1e-8):
    """Ridge fit in o-KAN layout: y [batch, in, out] -> coef [in, out,
    coeff]."""
    return curve2coeff(x, y, grid, k, ridge=lamb).permute(1, 0, 2)


def sparse_mask(in_dim: int, out_dim: int):
    """o-KAN's sparse connectivity: each input to its nearest output and
    each output to its nearest input on [0, 1]."""
    in_coord = (torch.arange(in_dim, dtype=torch.float32) + 0.5) / in_dim
    out_coord = (torch.arange(out_dim, dtype=torch.float32) + 0.5) / out_dim
    dist = (in_coord[:, None] - out_coord[None, :]).abs()
    mask = torch.zeros(in_dim, out_dim)
    mask[torch.arange(in_dim), dist.argmin(1)] = 1.0
    mask[dist.argmin(0), torch.arange(out_dim)] = 1.0
    return mask


def okan_forward(x, grid, coef, scale_base, scale_sp, mask, k: int,
                 return_acts: bool = False):
    """o-KAN forward in fp32:
    y[b, o] = sum_i mask[i, o] (scale_base[i, o] silu(x[b, i])
                                + scale_sp[i, o] spline_io(x[b, i])),
    each sum over i one matmul.  With ``return_acts`` the per-edge terms
    are formed and summed instead, and (y, preacts, postacts, postspline)
    come back in the JAX layout, each [batch, out, in]: x broadcast over
    the outputs, the masked edge terms and the bare splines."""
    x = x.float()
    if return_acts:
        postspline = coef2curve(x, grid, coef, k)            # [b, in, out]
        post = mask * (scale_base * F.silu(x)[..., None]
                       + scale_sp * postspline)
        preacts = x[:, None, :].expand(x.shape[0], coef.shape[1], x.shape[1])
        return (post.sum(1), preacts, post.transpose(1, 2),
                postspline.transpose(1, 2))
    base = F.silu(x) @ (mask * scale_base)
    w = coef * (mask * scale_sp)[..., None]                  # [in, out, c]
    return base + _spline_matmul(b_splines(x, grid, k), w.transpose(0, 1))


def okan_update_grid(x, grid, coef, k: int, num: int,
                     grid_eps: float = 0.02):
    """Re-grid an o-KAN layer to the samples x [batch, in] and refit its
    coefficients to keep its function.  Returns (new_grid, new_coef)."""
    batch = x.shape[0]
    x_sorted = torch.sort(x, dim=0).values
    y_eval = coef2curve(x_sorted, grid, coef, k)             # [b, in, out]
    ids = _okan_ids(batch, num).to(x.device)
    grid_adaptive = x_sorted[ids].t()                        # [in, num + 1]
    iota = torch.arange(num + 1, dtype=torch.float32, device=x.device)
    h = (grid_adaptive[:, -1:] - grid_adaptive[:, :1]) / num
    grid_uniform = grid_adaptive[:, :1] + h * iota[None, :]
    new_grid = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    new_grid = torch.cummax(new_grid, dim=1).values
    span = torch.clamp(new_grid[:, -1:] - new_grid[:, :1], min=1e-3)
    new_grid = new_grid + iota[None, :] * 1e-4 * span
    new_grid = extend_grid(new_grid, k)
    return new_grid, okan_curve2coef(x_sorted, y_eval, new_grid, k)


def okan_get_subset(grid, coef, scale_base, scale_sp, mask, in_idx,
                    out_idx):
    """o-KAN pruning: the layer restricted to the edges from the inputs
    ``in_idx`` to the outputs ``out_idx`` (in that order).  Returns (grid,
    coef, scale_base, scale_sp, mask)."""
    i = torch.as_tensor(in_idx, dtype=torch.int64, device=grid.device)
    o = torch.as_tensor(out_idx, dtype=torch.int64, device=grid.device)
    return (grid[i],) + tuple(t[i][:, o] for t in
                              (coef, scale_base, scale_sp, mask))


def okan_swap(arrs, i: int, j: int, axis: int):
    """o-KAN neuron swap: every tensor of ``arrs`` with its entries i and j
    along ``axis`` exchanged (new tensors; the inputs are not changed)."""
    out = []
    for a in arrs:
        idx = torch.arange(a.shape[axis], device=a.device)
        idx[i], idx[j] = j, i
        out.append(a.index_select(axis, idx))
    return out


def okan_refine_grid(grid, coef, new_num: int, k: int, samples=None,
                     n_eval: int = 256):
    """Grid refinement: the layer refit on a grid of ``new_num`` intervals
    over the same range, keeping its function: the splines are sampled at
    ``samples`` [n, in] (by default ``n_eval`` even points of each input's
    range) and refit on the new knots.  Returns (new_grid, new_coef)."""
    lo = grid[:, k][:, None]
    hi = grid[:, -(k + 1)][:, None]
    span = lambda n: _linspace_f32(0.0, 1.0, n).to(grid.device)[None, :]
    if samples is None:
        samples = (lo + (hi - lo) * span(n_eval)).t()        # [n_eval, in]
    y_eval = coef2curve(samples, grid, coef, k)              # [n, in, out]
    new_grid = extend_grid(lo + (hi - lo) * span(new_num + 1), k)
    return new_grid, okan_curve2coef(samples, y_eval, new_grid, k)
