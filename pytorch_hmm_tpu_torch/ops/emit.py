"""Diagonal-Gaussian emission scoring with one read of the observations.

Port of ``pytorch_hmm_tpu/ops/emit.py``::

    out = (x ⊙ x) @ Wq + x @ Wl + bias

On CUDA tensors :func:`diag_quadratic` launches the hand-written kernel
in ``csrc/diag_quadratic.cu`` (true float32); on CPU tensors it runs
:func:`diag_quadratic_reference`, the plain torch version the kernel is
held against. Either way it is a ``torch.autograd.Function`` whose
backward is three plain products and a sum.
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
    """Plain torch ``(obs²) @ wq + obs @ wl + bias``, squared in at least
    f32."""
    obs = obs.to(torch.promote_types(obs.dtype, torch.float32))
    return (obs * obs) @ wq + obs @ wl + bias


def _launch(obs, wq, wl, bias) -> torch.Tensor:
    """One launch of the CUDA kernel (counted in ``diag_quadratic.launches``)."""
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


class _DiagQuadratic(torch.autograd.Function):
    """The kernel (or, on CPU tensors, the plain version) forward; the
    backward is plain torch products, as the JAX kernel has no VJP of
    its own and XLA differentiates its plain form:
    ``dobs = 2·obs⊙(g@wqᵀ) + g@wlᵀ``, ``dwq = (obs²)ᵀg``, ``dwl = obsᵀg``,
    ``dbias = Σg``."""

    @staticmethod
    def forward(ctx, obs, wq, wl, bias):
        ctx.save_for_backward(obs, wq, wl)
        if obs.device.type == "cpu":
            return diag_quadratic_reference(obs, wq, wl, bias)
        return _launch(obs, wq, wl, bias)

    @staticmethod
    def backward(ctx, g):
        obs, wq, wl = ctx.saved_tensors
        x = obs.to(g.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        need = ctx.needs_input_grad
        d_obs = (2.0 * x * (g @ wq.T) + g @ wl.T).to(obs.dtype) if need[0] else None
        d_wq = (x2 * x2).T @ g2 if need[1] else None
        d_wl = x2.T @ g2 if need[2] else None
        d_bias = g2.sum(0) if need[3] else None
        return d_obs, d_wq, d_wl, d_bias


def diag_quadratic(
    obs: torch.Tensor,    # (B, T, D)
    wq: torch.Tensor,     # (D, N)  e.g. inv_var per component column
    wl: torch.Tensor,     # (D, N)  e.g. -2 μ·inv_var
    bias: torch.Tensor,   # (N,)    e.g. Σ μ²·inv_var
) -> torch.Tensor:
    """``(B, T, N)`` = ``(obs²) @ wq + obs @ wl + bias``, differentiable
    in all four inputs.

    CUDA tensors run the kernel (counted in ``diag_quadratic.launches``)
    and must be float32, contiguous and on one device; anything else
    raises. CPU tensors run the plain version. Both go through one
    ``torch.autograd.Function``, so the backward is the same on both.
    """
    return _DiagQuadratic.apply(obs, wq, wl, bias)


diag_quadratic.launches = 0
