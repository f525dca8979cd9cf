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

Every kernel is called through one seam: a module declares each library
it calls once, as a :class:`Library` of its entry points' ``argtypes``,
and launches with :meth:`Library.launch`, which marshals the arguments,
appends the device and stream every entry point takes last, and raises
on the code it returns. A failed build raises with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from itertools import takewhile
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "MAX_SMALLK", "LaunchError", "Library", "build", "check",
           "check_problem", "check_tensors", "library_path", "load"]

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


class LaunchError(RuntimeError):
    """A kernel's C entry point returned CUDA error ``rc``."""

    def __init__(self, rc: int, what: str):
        super().__init__(f"{what} kernel launch failed: CUDA error {rc}")
        self.rc = rc


def check(rc: int, what: str) -> None:
    """Raise :class:`LaunchError` if a kernel's C entry point returned a
    CUDA error."""
    if rc != 0:
        raise LaunchError(rc, what)


class Library:
    """``csrc/<name>.cu`` built with ``defines``, and the entry points a
    module calls in it (``signatures``: ``{entry: [ctypes types]}``). Every
    entry point takes its buffers first (``c_void_p``), then numbers, then
    the device index and the stream handle. Declaring one builds and loads
    nothing; the first launch does, and declares every entry's
    ``argtypes`` once."""

    def __init__(self, name: str, signatures: dict, defines: tuple = ()):
        self.name, self.signatures, self.defines = name, signatures, tuple(defines)
        self._entries: dict = {}

    def fn(self, entry: str):
        """The loaded C function ``entry``."""
        return (self._entries.get(entry) or self._load(entry))[0]

    def _load(self, entry: str) -> tuple:
        """Load the library; ``(function, number of buffers)`` of ``entry``."""
        lib = load(self.name, self.signatures, self.defines)
        for e, types in self.signatures.items():
            buffers = len(list(takewhile(lambda t: t is ctypes.c_void_p, types)))
            self._entries[e] = (getattr(lib, e), buffers)
        return self._entries[entry]

    def launch(self, entry: str, what: str, *args) -> None:
        """Call ``entry`` with ``args``: each buffer a tensor, passed as its
        ``data_ptr()``, or ``None``, a null pointer; the numbers as they
        are; then the index of the first buffer's device (the current
        device where the entry takes no buffer) and the handle of that
        device's current stream. Raises :class:`LaunchError` (``what``
        names the kernel) on a nonzero return."""
        fn, n = self._entries.get(entry) or self._load(entry)
        dev = args[0].device if n else None
        rc = fn(*[None if a is None else a.data_ptr() for a in args[:n]], *args[n:],
                torch.cuda.current_device() if dev is None else dev.index,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise LaunchError(rc, what)


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


# One warp lane per state: the chain kernels' state bound.
MAX_SMALLK = 32


def check_problem(what: str, log_obs, log_a, log_pi=None, lengths=None,
                  time_varying: bool = False, max_states: int = MAX_SMALLK):
    """Validate the shapes of an HMM problem for a CUDA kernel
    (``log_pi`` may be omitted; ``log_a`` is ``(K, K)``, or ``(B, T, K,
    K)`` where the kernel has a ``time_varying`` mode; ``1 <= K <=
    max_states``); returns ``(B, T, K, lengths)`` with ``lengths`` None or
    contiguous int32 ``(B,)`` on ``log_obs``'s device."""
    if log_obs.ndim != 3:
        raise ValueError(f"{what}: log_obs must be (B, T, K), got {tuple(log_obs.shape)}")
    B, T, K = log_obs.shape
    shapes = [(K, K)] + ([(B, T, K, K)] if time_varying else [])
    if tuple(log_a.shape) not in shapes or (log_pi is not None and tuple(log_pi.shape) != (K,)):
        raise ValueError(
            f"{what}: log_obs {tuple(log_obs.shape)} needs log_a "
            + " or ".join(str(s) for s in shapes) + f" and log_pi ({K},), got "
            + str(tuple(log_a.shape))
            + ("" if log_pi is None else f" and {tuple(log_pi.shape)}")
        )
    if not 1 <= K <= max_states:
        raise ValueError(f"{what} takes 1 <= K <= {max_states}, got K={K}")
    if B == 0 or T == 0:
        raise ValueError(f"{what}: empty input {tuple(log_obs.shape)}")
    dev = log_obs.device
    if lengths is not None and (
        lengths.device != dev or lengths.dtype != torch.int32
        or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()
    ):
        raise ValueError(
            f"{what}: lengths must be contiguous int32 ({B},) on {dev}, got "
            f"{lengths.dtype} {tuple(lengths.shape)} on {lengths.device}"
        )
    return B, T, K, lengths
