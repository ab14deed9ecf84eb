"""The dispatch rules the kernel wrappers share.

``impl`` is "auto" (the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor), "cuda" (launch the kernel or raise) or "torch" (the
plain version on any device).  Under autograd each kernel's entry point
goes through its ``torch.autograd.Function``, whose backward dispatches by
the same rule, so no output of a kernel loses its ``grad_fn``.  A forward
kernel is reached through its ``torch.library`` op (``kernels/ops.py``,
``via_op``), so that ``torch.export`` carries it into a program.
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


def via_op(impl: str, t: torch.Tensor) -> bool:
    """Whether a forward resolved to ``impl`` for operand ``t`` goes through
    its ``kernels/ops.py`` op, which takes ``impl`` on (the kernel for
    "cuda", the plain version for "torch"): every call but one that asks
    for the plain version on the card, which runs it directly."""
    return impl == "cuda" or not t.is_cuda


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


def pass_info(name: str, passes, C: int, dtype) -> dict:
    """What the card grants each pass of ``csrc/<name>.cu`` at channels
    ``C`` and operand type ``dtype``, from its C entry
    ``<name>_pass_info``: {pass: (registers a thread, local-memory bytes a
    thread (spills), shared bytes a block, resident warps per SM)}, from
    cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from medical_image_classification_tpu_torch.kernels import _build

    lib = _build.library(name)
    fn = getattr(lib, f"{name}_pass_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (4 * len(passes)))()
    _build.raise_on_error(lib, name, fn(C, int(dtype == torch.bfloat16),
                                        ctypes.addressof(out)))
    return {p: tuple(out[4 * i:4 * i + 4]) for i, p in enumerate(passes)}
