"""Diagonal-Gaussian emission scoring with one read of the observations.

Port of ``pytorch_hmm_tpu/ops/emit.py``::

    out = (x ⊙ x) @ Wq + x @ Wl + bias

On CUDA tensors :func:`diag_quadratic` launches the hand-written kernel
in ``csrc/diag_quadratic.cu`` (true float32); on CPU tensors it runs
:func:`diag_quadratic_reference`, the plain torch version the kernel is
held against.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["diag_quadratic", "diag_quadratic_reference"]

_SIGNATURES = {
    "diag_quadratic_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ],
}


def diag_quadratic_reference(
    obs: torch.Tensor, wq: torch.Tensor, wl: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain torch ``(obs²) @ wq + obs @ wl + bias``, squared in f32."""
    obs = obs.to(torch.float32)
    return (obs * obs) @ wq + obs @ wl + bias


def diag_quadratic(
    obs: torch.Tensor,    # (B, T, D)
    wq: torch.Tensor,     # (D, N)  e.g. inv_var per component column
    wl: torch.Tensor,     # (D, N)  e.g. -2 μ·inv_var
    bias: torch.Tensor,   # (N,)    e.g. Σ μ²·inv_var
) -> torch.Tensor:
    """``(B, T, N)`` = ``(obs²) @ wq + obs @ wl + bias``.

    CUDA tensors run the kernel (counted in ``diag_quadratic.launches``)
    and must be float32, contiguous and on one device; anything else
    raises. CPU tensors run the plain version.
    """
    if obs.device.type == "cpu":
        return diag_quadratic_reference(obs, wq, wl, bias)
    if obs.ndim != 3 or wq.ndim != 2 or wl.shape != wq.shape or bias.ndim != 1:
        raise ValueError(
            "diag_quadratic takes obs (B, T, D), wq/wl (D, N), bias (N,); got "
            f"{tuple(obs.shape)}, {tuple(wq.shape)}, {tuple(wl.shape)}, "
            f"{tuple(bias.shape)}"
        )
    B, T, D = obs.shape
    N = wq.shape[1]
    if wq.shape[0] != D or bias.shape[0] != N:
        raise ValueError(
            f"diag_quadratic: obs D={D}, wq {tuple(wq.shape)}, bias N={bias.shape[0]}"
        )
    if B * T == 0 or D == 0 or N == 0:
        raise ValueError(f"diag_quadratic: empty input, obs {tuple(obs.shape)}, N={N}")
    _build.check_tensors("diag_quadratic", obs.device, obs=obs, wq=wq, wl=wl, bias=bias)

    lib = _build.load("diag_quadratic", _SIGNATURES)
    out = torch.empty((B, T, N), dtype=torch.float32, device=obs.device)
    rc = lib.diag_quadratic_f32(
        obs.data_ptr(), wq.data_ptr(), wl.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B * T, D, N, obs.device.index,
        torch.cuda.current_stream(obs.device).cuda_stream,
    )
    _build.check(rc, "diag_quadratic")
    diag_quadratic.launches += 1
    return out


diag_quadratic.launches = 0

