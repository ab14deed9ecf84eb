"""The forward kernels as torch.library custom ops, namespace ``mic_torch``.

One op per forward kernel of the models' paths, named after its CUDA
source: ``selective_scan_fwd`` (row 1), ``ssd_fused_dirs_fwd`` (5),
``ssd_fused_fwd`` (6), ``ssd_ydiag_fwd`` (7), ``stl_mixer_fwd`` (8) and
``stf_zgate_fwd`` (9).  Each op's implementation is its wrapper module's
``op_forward``; its last argument ``impl`` is the wrapper's resolved
choice: "cuda" launches the kernel (the argument checks, the dense copies,
the pointers, the launch and its count all happen in there), "torch" runs
the plain version (what "auto" resolves to on the CPU).  Its fake
(``register_fake``) gives the shapes and dtypes of the outputs, so
``torch.export`` traces a model through the ops without touching storage,
and the exported program holds ``mic_torch::*`` calls.  Every output is
freshly allocated.

A program that holds these ops runs only where they are registered:
import this module before ``torch.export.load``.  It imports nothing of the
models.  The ops carry no autograd formula: training reaches them inside
the autograd Functions' forwards (``ScanFolded``, ``SSDFusedDirs``,
``SSDFused``, ``YDiagFused``, ``STLMixer``, ``STFZGate``), whose backwards
call the backward kernels.
"""

import importlib

import torch

NAMESPACE = "mic_torch"


def _impl(module: str):
    """The op body: ``kernels/<module>.py``'s ``op_forward``, looked up at
    call time (this module imports none of the wrappers, which import it)."""
    def run(*args):
        return importlib.import_module(
            f"medical_image_classification_tpu_torch.kernels.{module}"
        ).op_forward(*args)
    return run


def _op(name: str, module: str, schema: str):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", _impl(module),
                                   mutates_args=(), schema=schema)


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

# every op, in the order of the rows above
OPS = (selective_scan_fwd, ssd_fused_dirs_fwd, ssd_fused_fwd, ssd_ydiag_fwd,
       stl_mixer_fwd, stf_zgate_fwd)


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
