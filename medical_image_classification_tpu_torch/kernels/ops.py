"""The kernels as torch.library custom ops, namespace ``mic_torch``.

One op per kernel of the models' paths, named after its CUDA source:
``selective_scan_fwd`` / ``_bwd`` (rows 1-2), ``ssd_fused_dirs_fwd`` /
``_bwd`` (5, 5b), ``ssd_fused_fwd`` / ``_bwd`` (6, 6b), ``ssd_ydiag_fwd`` /
``_bwd`` (7, 7b), ``stl_mixer_fwd`` / ``_bwd`` (8, 8b) and
``stf_zgate_fwd`` / ``_bwd`` (9, 9b).  Each op's implementation is its
wrapper module's ``op_forward`` (``op_backward``); its last argument
``impl`` is the wrapper's resolved
choice: "cuda" launches the kernel (the argument checks, the dense copies,
the pointers, the launch and its count all happen in there), "torch" runs
the plain version (what "auto" resolves to on the CPU).  Its fake
(``register_fake``) gives the shapes and dtypes of the outputs, so
``torch.export`` traces a model through the ops without touching storage,
and the exported program holds ``mic_torch::*`` calls; FakeTensorMode
(``utils/flops.py``) takes a model's forward and backward through them
without computing.  Every output is freshly allocated; a backward op's
cotangents come in their primals' dtypes.

Each op also has its FLOP formula in FlopCounterMode's registry
(``flop_formulas.py``, ``OP_FORMULAS``), so a count of a model's FLOPs
counts the op and not the aten ops of the plain version inside it.

A program that holds these ops runs only where they are registered:
import this module before ``torch.export.load``.  It imports nothing of the
models.  The ops carry no autograd formula: training reaches the forward
ops inside the autograd Functions' forwards (``ScanFolded``,
``SSDFusedDirs``, ``SSDFused``, ``YDiagFused``, ``STLMixer``,
``STFZGate``), and the backward ops inside their backwards.
"""

import importlib

import torch
from torch.utils.flop_counter import register_flop_formula

from medical_image_classification_tpu_torch.kernels.flop_formulas import (
    OP_FORMULAS,
)

NAMESPACE = "mic_torch"


def _impl(module: str, body: str):
    """The op body: ``kernels/<module>.py``'s ``body`` (``op_forward`` or
    ``op_backward``), looked up at call time (this module imports none of
    the wrappers, which import it)."""
    def run(*args):
        return getattr(importlib.import_module(
            f"medical_image_classification_tpu_torch.kernels.{module}"),
            body)(*args)
    return run


def _op(name: str, module: str, schema: str, body: str = "op_forward"):
    return torch.library.custom_op(f"{NAMESPACE}::{name}",
                                   _impl(module, body), mutates_args=(),
                                   schema=schema)


selective_scan_fwd = _op(
    "selective_scan_fwd", "selective_scan_fwd",
    "(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor D, "
    "Tensor bias, Tensor? init, bool reverse, bool softplus, "
    "bool want_xsave, bool want_state, str impl) -> Tensor[]")
ssd_fused_dirs_fwd = _op(
    "ssd_fused_dirs_fwd", "ssd_fused_dirs",
    "(Tensor stackr, Tensor acum, Tensor dte, Tensor cdec, Tensor dtp, "
    "Tensor Dsk, int d_ssm, int gn, bool want_save, str impl) -> Tensor[]")
ssd_fused_fwd = _op(
    "ssd_fused_fwd", "ssd_fused",
    "(Tensor Cc, Tensor Bc, Tensor acum, Tensor dte, Tensor cdec, "
    "Tensor dtp, Tensor x, bool want_save, str impl) -> Tensor[]")
ssd_ydiag_fwd = _op(
    "ssd_ydiag_fwd", "ssd_ydiag",
    "(Tensor Cc, Tensor Bc, Tensor acum, Tensor dtx, str impl) -> Tensor")
stl_mixer_fwd = _op(
    "stl_mixer_fwd", "stl_mixer",
    "(Tensor w, Tensor u1, Tensor V, str impl) -> (Tensor, Tensor)")
stf_zgate_fwd = _op(
    "stf_zgate_fwd", "stf_zgate",
    "(Tensor pooledT, Tensor lz, Tensor U, str impl) -> Tensor")

# every forward op, in the order of the rows above
OPS = (selective_scan_fwd, ssd_fused_dirs_fwd, ssd_fused_fwd, ssd_ydiag_fwd,
       stl_mixer_fwd, stf_zgate_fwd)


selective_scan_bwd = _op(
    "selective_scan_bwd", "selective_scan_bwd",
    "(Tensor u, Tensor delta, Tensor A, Tensor B, Tensor C, Tensor D, "
    "Tensor bias, Tensor xsave, Tensor dy, Tensor? dlast, bool reverse, "
    "bool softplus, bool want_dinit, str impl) -> Tensor[]",
    "op_backward")
ssd_fused_dirs_bwd = _op(
    "ssd_fused_dirs_bwd", "ssd_fused_dirs",
    "(Tensor stackr, Tensor acum, Tensor dte, Tensor cdec, Tensor dtp, "
    "Tensor Dsk, int d_ssm, int gn, Tensor Ssave, Tensor dy, str impl) "
    "-> Tensor[]",
    "op_backward")
ssd_fused_bwd = _op(
    "ssd_fused_bwd", "ssd_fused",
    "(Tensor Cc, Tensor Bc, Tensor acum, Tensor dte, Tensor cdec, "
    "Tensor dtp, Tensor x, Tensor Ssave, Tensor dy, str impl) -> Tensor[]",
    "op_backward")
ssd_ydiag_bwd = _op(
    "ssd_ydiag_bwd", "ssd_ydiag",
    "(Tensor Cc, Tensor Bc, Tensor acum, Tensor dtx, Tensor dy, str impl) "
    "-> Tensor[]",
    "op_backward")
stl_mixer_bwd = _op(
    "stl_mixer_bwd", "stl_mixer",
    "(Tensor w, Tensor u1, Tensor V, Tensor dU, Tensor? lse, str impl) "
    "-> Tensor[]",
    "op_backward")
stf_zgate_bwd = _op(
    "stf_zgate_bwd", "stf_zgate",
    "(Tensor pooledT, Tensor lz, Tensor U, Tensor dY, str impl) "
    "-> Tensor[]",
    "op_backward")

# every backward op, in the order of OPS
BWD_OPS = (selective_scan_bwd, ssd_fused_dirs_bwd, ssd_fused_bwd,
           ssd_ydiag_bwd, stl_mixer_bwd, stf_zgate_bwd)

for _name, _formula in OP_FORMULAS.items():
    register_flop_formula(getattr(getattr(torch.ops, NAMESPACE), _name))(
        _formula)


@selective_scan_fwd.register_fake
def _(u, delta, A, B, C, D, bias, init, reverse, softplus, want_xsave,
      want_state, impl):
    from medical_image_classification_tpu_torch.kernels.selective_scan_fwd \
        import CHUNK
    G, L, Dm = u.shape
    N = A.shape[2]
    outs = [u.new_empty(u.shape)]
    if want_xsave:
        outs.append(u.new_empty((G, -(-L // CHUNK), N, Dm),
                                dtype=torch.float32))
    if want_state:
        outs.append(u.new_empty((G, N, Dm), dtype=torch.float32))
    return outs


@ssd_fused_dirs_fwd.register_fake
def _(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, want_save, impl):
    B, nc, l, _ = stackr.shape
    H4 = acum.shape[2]
    P = d_ssm // (H4 // 4)
    outs = [stackr.new_empty((B, nc, l, H4 * P))]
    if want_save:
        outs.append(stackr.new_empty((B, nc, H4, P, 4 * gn)))
    return outs


@ssd_fused_fwd.register_fake
def _(Cc, Bc, acum, dte, cdec, dtp, x, want_save, impl):
    B, nc, l, N = Cc.shape
    H = acum.shape[2]
    outs = [x.new_empty(x.shape)]
    if want_save:
        outs.append(Cc.new_empty((B, nc, H, x.shape[3] // H, N)))
    return outs


@ssd_ydiag_fwd.register_fake
def _(Cc, Bc, acum, dtx, impl):
    return dtx.new_empty(dtx.shape)


@stl_mixer_fwd.register_fake
def _(w, u1, V, impl):
    BB, L, C = w.shape
    return (w.new_empty((BB, u1.shape[1], C)),
            w.new_empty((BB, L), dtype=torch.float32))


@stf_zgate_fwd.register_fake
def _(pooledT, lz, U, impl):
    return pooledT.new_empty(pooledT.shape)


# each backward op's fake: the cotangents of its primals, in their shapes
# and dtypes (the scan's dinit [G, N, Dm] fp32 after them); a cotangent
# that the body sums over the batch as a transpose keeps its strides
@selective_scan_bwd.register_fake
def _(u, delta, A, B, C, D, bias, xsave, dy, dlast, reverse, softplus,
      want_dinit, impl):
    K, Dm, N = A.shape
    dA = A.new_empty((K, N, Dm)).transpose(1, 2)
    outs = [torch.empty_like(t) for t in (u, delta)] + [dA] + [
        torch.empty_like(t) for t in (B, C, D, bias)]
    if want_dinit:
        outs.append(u.new_empty((u.shape[0], A.shape[2], u.shape[2]),
                                dtype=torch.float32))
    return outs


@ssd_fused_dirs_bwd.register_fake
def _(stackr, acum, dte, cdec, dtp, Dsk, d_ssm, gn, Ssave, dy, impl):
    return [torch.empty_like(t) for t in (stackr, acum, dte, cdec, dtp, Dsk)]


@ssd_fused_bwd.register_fake
def _(Cc, Bc, acum, dte, cdec, dtp, x, Ssave, dy, impl):
    return [torch.empty_like(t) for t in (Cc, Bc, acum, dte, cdec, dtp, x)]


@ssd_ydiag_bwd.register_fake
def _(Cc, Bc, acum, dtx, dy, impl):
    return [torch.empty_like(t) for t in (Cc, Bc, acum, dtx)]


@stl_mixer_bwd.register_fake
def _(w, u1, V, dU, lse, impl):
    return [torch.empty_like(w), u1.new_empty(u1.shape[::-1]).t(),
            torch.empty_like(V)]


@stf_zgate_bwd.register_fake
def _(pooledT, lz, U, dY, impl):
    return [torch.empty_like(pooledT), lz.new_empty(lz.shape[::-1]).t(),
            torch.empty_like(U)]
