"""Diagonal-Gaussian emission scoring with one read of the observations.

Port of ``pytorch_hmm_tpu/ops/emit.py``::

    out = (x ⊙ x) @ Wq + x @ Wl + bias

On CUDA tensors :func:`diag_quadratic` launches the hand-written kernel
in ``csrc/diag_quadratic.cu`` (true float32, launched as :func:`dq_plan`
tiles it); on CPU tensors it runs
:func:`diag_quadratic_reference`, the plain torch version the kernel is
held against. Either way it is a ``torch.autograd.Function`` whose
backward is three plain products and a sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["DQPlan", "diag_quadratic", "diag_quadratic_reference", "dq_plan"]

_SIGNATURES = {
    "diag_quadratic_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}

# The kernel's fixed tiling (csrc/diag_quadratic.cu): 128-row tiles, D in
# 16-feature units through a 4-stage ring, an output staging tile; weights
# stay resident while both (D, tile) slices take at most 96 KB.
DQ_ROWS, DQ_CHUNK, DQ_STAGES = 128, 16, 4
DQ_RESIDENT_BYTES = 96 * 1024
SMEM_LIMIT = 232448


class DQPlan(NamedTuple):
    tn: int            # columns per thread: the column tile is 8 * tn
    col_tiles: int
    resident: bool     # weights staged once per block, or per ring unit
    smem: int          # dynamic shared memory bytes a block takes


def _plan(D: int, tn: int, tiles: int) -> DQPlan:
    """The plan of ``tiles`` column tiles of ``8 * tn`` columns over ``D``
    features; its bytes are those the kernel's ``layout()`` carves."""
    row = 8 * tn                                 # floats per feature of a weight tile
    weights = 4 * 2 * -(-D // DQ_CHUNK) * DQ_CHUNK * row
    resident = weights <= DQ_RESIDENT_BYTES
    stage = DQ_ROWS * DQ_CHUNK + (0 if resident else 2 * DQ_CHUNK * row)
    staging = 4 * DQ_ROWS * (row + 4)            # the finished tile on its way out
    return DQPlan(tn, tiles, resident, 4 * DQ_STAGES * stage + (weights if resident else 0) + staging)


@functools.lru_cache(maxsize=64)
def dq_plan(D: int, N: int) -> DQPlan:
    """The kernel's launch plan for ``D`` features and ``N`` columns:
    ``ceil(N / 64)`` column tiles of ``8 * tn`` columns, ``tn`` as small
    as covers N (N=48: one tile of 48; N=256: four of 64). The wrapper
    passes all of it to the kernel, which checks the bytes against its
    own shared-memory layout."""
    tiles = -(-N // 64)
    return _plan(D, -(-N // (8 * tiles)), tiles)


def diag_quadratic_reference(
    obs: torch.Tensor, wq: torch.Tensor, wl: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain torch ``(obs²) @ wq + obs @ wl + bias``, squared in at least
    f32."""
    obs = obs.to(torch.promote_types(obs.dtype, torch.float32))
    return (obs * obs) @ wq + obs @ wl + bias


def _launch(obs, wq, wl, bias, plan: DQPlan | None = None) -> torch.Tensor:
    """One launch of the CUDA kernel on ``plan`` (:func:`dq_plan` unless
    given), counted in ``diag_quadratic.launches``."""
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
    plan = dq_plan(D, N) if plan is None else plan
    out = torch.empty((B, T, N), dtype=torch.float32, device=obs.device)
    rc = lib.diag_quadratic_f32(
        obs.data_ptr(), wq.data_ptr(), wl.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B * T, D, N, plan.tn, plan.col_tiles, int(plan.resident), plan.smem,
        obs.device.index,
        torch.cuda.current_stream(obs.device).cuda_stream,
    )
    _build.check(rc, "diag_quadratic")
    diag_quadratic.launches += 1
    return out


def _forward(obs, wq, wl, bias) -> torch.Tensor:
    """The plain version on CPU tensors, else the kernel."""
    if obs.device.type == "cpu":
        return diag_quadratic_reference(obs, wq, wl, bias)
    return _launch(obs, wq, wl, bias)


class _DiagQuadratic(torch.autograd.Function):
    """The kernel (or, on CPU tensors, the plain version) forward; the
    backward is plain torch products, as the JAX kernel has no VJP of
    its own and XLA differentiates its plain form:
    ``dobs = 2·obs⊙(g@wqᵀ) + g@wlᵀ``, ``dwq = (obs²)ᵀg``, ``dwl = obsᵀg``,
    ``dbias = Σg``."""

    @staticmethod
    def forward(ctx, obs, wq, wl, bias):
        ctx.save_for_backward(obs, wq, wl)
        return _forward(obs, wq, wl, bias)

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
    ``torch.autograd.Function``, so the backward is the same on both;
    where no gradient is recorded the forward runs without it.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (obs, wq, wl, bias)):
        return _DiagQuadratic.apply(obs, wq, wl, bias)
    return _forward(obs, wq, wl, bias)


diag_quadratic.launches = 0
