"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions that
launch a kernel on the stream they are given and return
``cudaGetLastError()``. At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``_build/lib<name>-<hash>.so``, where the hash covers
the source and the compiler flags, and loaded with ``ctypes``. A build
with macros defined (``defines``, for example a probe build) is a
separate library beside the plain one. Nothing
is built or loaded when the package is imported, so it imports on
machines with no GPU and no CUDA toolkit.

A failed build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "check", "check_tensors", "library_path", "load"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch resolves it,
    then ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found "
        "(set CUDA_HOME or put nvcc on PATH)"
    )


def _flags(defines: tuple) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where ``csrc/<name>.cu`` is built to, keyed by source and flags
    (``defines``: macros passed as ``-D``)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists."""
    out = library_path(name, defines)
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename: concurrent builds never
    # see a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_flags(defines), "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, signatures: dict, defines: tuple = ()) -> ctypes.CDLL:
    """Build if needed, then load ``csrc/<name>.cu`` and declare the
    ``argtypes`` of each exported function in ``signatures`` (``{fn:
    [ctypes types]}``) not declared yet, so modules that share one
    library each declare the functions they call. Every function
    returns a CUDA error code as ``int``. ``defines`` selects a build with
    those macros defined."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, tuple(defines))))
        _loaded[key] = lib
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def check_tensors(what: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on
    ``device`` that records no gradient. A raw launch is invisible to
    autograd; the differentiable paths (``ops.emit.diag_quadratic``,
    ``ops.pallas_log_likelihood``, ``ops._pallas_ll_masked``) launch
    inside ``torch.autograd.Function``s, where grad mode is off."""
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{what}: a raw kernel launch records no gradient for {name}; "
                "differentiate through its autograd Function (ops.emit.diag_quadratic, "
                "ops.auto_log_likelihood) or call it under torch.no_grad()"
            )
