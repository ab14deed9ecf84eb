"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers).  It is compiled at first use for
``sm_90a`` into ``build/torch_kernels/`` at the root of the checkout, under
a name that carries a hash of the source, the headers and the flags, so an
edited source is rebuilt.  A failed compile raises with
the compiler's output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float          # compile time; 0.0 when the library was cached
    log: str                # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin): the CUDA kernels of "
                       "this package cannot be built here")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    and these flags is already in the build directory."""
    src = CSRC_DIR / f"{name}.cu"
    # the shared headers count too: a source includes them by name
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildResult(out, time.perf_counter() - t0,
                       (proc.stdout + proc.stderr).strip())


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _LOADED[name] = lib
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch through ``lib.<name>`` returned a CUDA error code;
    the library exports ``<name>_error_string``."""
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
