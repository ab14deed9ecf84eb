"""The dispatch rules the kernel wrappers share.

``impl`` is "auto" (the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor), "cuda" (launch the kernel or raise) or "torch" (the
plain version on any device).  A kernel with no backward yet refuses a
call that autograd would have to differentiate, rather than return an
output without a gradient.
"""

from __future__ import annotations

import ctypes

import torch


def resolve_impl(impl: str, t: torch.Tensor, what: str) -> str:
    """"cuda" or "torch" for an operand ``t`` of the kernel ``what``."""
    if impl == "auto":
        impl = "cuda" if t.is_cuda else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown {what} impl: {impl!r} "
                         "(expected 'auto', 'cuda' or 'torch')")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; the {what} "
                         f"operands are on {t.device}")
    return impl


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would need the backward of the forward-only
    kernel ``what``: grad mode on and an operand that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has a forward only, so st_ssd trains "
            "on the CPU (the plain versions) but not yet on the card; its "
            "backward kernels are the next slice (ROADMAP.md Queue 1 item "
            "9b, Queue 2 rows 7b-9b)")


def dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and 16-byte aligned (the kernels load
    16-byte vectors), else a fresh contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def call(name: str, argtypes, args) -> None:
    """Launch ``csrc/<name>.cu``'s C entry point ``name`` (built and loaded
    on first use) and raise on the CUDA error code it returns."""
    from medical_image_classification_tpu_torch.kernels import _build

    lib = _build.library(name)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _build.raise_on_error(lib, name, fn(*args))
