"""The dispatch rules the kernel wrappers share.

``impl`` is "auto" (the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor), "cuda" (launch the kernel or raise) or "torch" (the
plain version on any device).  Under autograd each kernel's entry point
goes through its ``torch.autograd.Function``, whose backward dispatches by
the same rule, so no output of a kernel loses its ``grad_fn``.
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
