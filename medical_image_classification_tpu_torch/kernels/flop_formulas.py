"""The hand kernels' FLOP formulas, for a counting
``torch.utils.flop_counter.FlopCounterMode``.

FLOPs as FlopCounterMode counts its products, two a multiply-add, from the
operands' shapes; the same number on the CPU, where the plain twins run,
and on the card:

- each op ``mic_torch::*``, forward and backward, has its formula in
  ``OP_FORMULAS``, which ``ops.py`` registers with
  ``register_flop_formula``, so the counter counts the op and not the
  plain twin's aten ops inside it;
- the formulas build on the JAX package's models (``utils/flops.py``):
  the Mamba-1 scan (rows 1-2) 2 x ``selective_scan_flops`` over G
  sequences of Dm channels; the fused SSD (rows 5-6) 2 x ``ssd_flops``,
  which counts the scores per head (the kernels compute them once a chunk:
  the count is the model's, not the kernels' work); Y_diag (row 7) 2 x its
  intra-chunk term; the STL mixer (row 8) and the STF gate (row 9), which
  no model covers, their two products; every backward 2 x its forward
  (each product's two cotangent products, FlopCounterMode's rule for a
  matmul).

A kernels module: the exported programs' loaders import it with
``ops.py`` and nothing else of the port.
"""

from __future__ import annotations


def _ssd_macs(B: int, nc: int, l: int, H: int, P: int, N: int) -> int:
    """``utils/flops.py::ssd_flops(B, nc l, H, P, N, l)``: per chunk and
    head the scores C B^T and Y_diag, the state B^T x and Y_off C S."""
    return B * nc * H * (l * l * (N + P) + 2 * l * N * P)


def scan_fwd_flops(u_shape, A_shape) -> int:
    """Row 1: u [G, L, Dm], A [K, Dm, N]: 2 x ``utils/flops.py::
    selective_scan_flops(G, L, Dm, N)`` (9 multiply-adds a state step,
    the D skip)."""
    G, L, Dm = u_shape
    return 2 * (9 * G * L * Dm * A_shape[2] + G * L * Dm)


def ssd_dirs_fwd_flops(stack_shape, acum_shape, d_ssm: int, gn: int) -> int:
    """Row 5: stackr [B, nc, l, 2 C'], acum [B, nc, H4, l]: 2 x
    ``ssd_flops`` with the four directions as H4 heads over the coupled
    state N = 4 gn."""
    B, nc, l, _ = stack_shape
    H4 = acum_shape[2]
    return 2 * _ssd_macs(B, nc, l, H4, d_ssm // (H4 // 4), 4 * gn)


def ssd_fused_fwd_flops(C_shape, acum_shape, x_shape) -> int:
    """Row 6: Cc [B, nc, l, N], acum [B, nc, H, l], x [B, nc, l, H P]: 2 x
    ``ssd_flops``."""
    B, nc, l, N = C_shape
    H = acum_shape[2]
    return 2 * _ssd_macs(B, nc, l, H, x_shape[3] // H, N)


def ydiag_fwd_flops(C_shape, dtx_shape) -> int:
    """Row 7: Cc [BC, l, N], dtx [BC, H, l, P]: 2 x ``ssd_flops``'
    intra-chunk term of one chunk."""
    BC, l, N = C_shape
    H, P = dtx_shape[1], dtx_shape[3]
    return 2 * BC * H * l * l * (N + P)


def stl_mixer_fwd_flops(w_shape, u1_shape) -> int:
    """Row 8: w [BB, L, C], u1 [C, P]: S = w u1 and U = E^T V."""
    BB, L, C = w_shape
    return 2 * 2 * BB * L * u1_shape[1] * C


def stf_zgate_fwd_flops(pooled_shape) -> int:
    """Row 9: pooledT [BB, P, C]: pooledT lz and Z U."""
    BB, P, C = pooled_shape
    return 2 * 2 * BB * P * P * C


# each op's formula, by op name, in FlopCounterMode's form: the op's
# arguments with every tensor as its shape (``ops.py`` registers them); a
# backward op counts 2 x its forward
OP_FORMULAS = {
    "selective_scan_fwd": lambda u, delta, A, *a, out_shape=None, **k:
        scan_fwd_flops(u, A),
    "ssd_fused_dirs_fwd":
        lambda stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, *a,
        out_shape=None, **k: ssd_dirs_fwd_flops(stackr, acum, d_ssm, gn),
    "ssd_fused_fwd": lambda Cc, Bc, acum, dte, cdec, dtp, x, *a,
        out_shape=None, **k: ssd_fused_fwd_flops(Cc, acum, x),
    "ssd_ydiag_fwd": lambda Cc, Bc, acum, dtx, *a, out_shape=None, **k:
        ydiag_fwd_flops(Cc, dtx),
    "stl_mixer_fwd": lambda w, u1, V, *a, out_shape=None, **k:
        stl_mixer_fwd_flops(w, u1),
    "stf_zgate_fwd": lambda pooledT, lz, U, *a, out_shape=None, **k:
        stf_zgate_fwd_flops(pooledT),
    "selective_scan_bwd": lambda u, delta, A, *a, out_shape=None, **k:
        2 * scan_fwd_flops(u, A),
    "ssd_fused_dirs_bwd":
        lambda stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, *a,
        out_shape=None, **k: 2 * ssd_dirs_fwd_flops(stackr, acum, d_ssm, gn),
    "ssd_fused_bwd": lambda Cc, Bc, acum, dte, cdec, dtp, x, *a,
        out_shape=None, **k: 2 * ssd_fused_fwd_flops(Cc, acum, x),
    "ssd_ydiag_bwd": lambda Cc, Bc, acum, dtx, *a, out_shape=None, **k:
        2 * ydiag_fwd_flops(Cc, dtx),
    "stl_mixer_bwd": lambda w, u1, *a, out_shape=None, **k:
        2 * stl_mixer_fwd_flops(w, u1),
    "stf_zgate_bwd": lambda pooledT, *a, out_shape=None, **k:
        2 * stf_zgate_fwd_flops(pooledT),
}
