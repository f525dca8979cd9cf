"""Diagonal-Gaussian emission scoring with one read of the observations.

Port of ``pytorch_hmm_tpu/ops/emit.py``::

    out = (x ⊙ x) @ Wq + x @ Wl + bias

On CUDA tensors :func:`diag_quadratic` launches the hand-written kernel
in ``csrc/diag_quadratic.cu`` (true float32, launched as :func:`dq_plan`
tiles it); on CPU tensors it runs
:func:`diag_quadratic_reference`, the plain torch version the kernel is
held against. Either way it is a ``torch.autograd.Function`` whose
backward is three plain products and a sum.

:func:`diag_gmm_log_probs` is the same kernel in its mixture mode, for
the GMM decode: the columns are S states of C components, and the
kernel's output stage reduces each state's components by logsumexp, so
only the ``(B, T, S)`` state scores leave it (tiled by
:func:`mixture_plan`; no gradient; plain version
:func:`diag_gmm_log_probs_reference`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.semiring import logsumexp
from ..trace import span
from . import _build

__all__ = ["DQPlan", "diag_gmm_log_probs", "diag_gmm_log_probs_reference", "diag_quadratic",
           "diag_quadratic_reference", "dq_plan", "mixture_plan"]

_LIB = _build.Library("diag_quadratic", {
    "diag_quadratic_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "diag_gmm_f32": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
})

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


@functools.lru_cache(maxsize=64)
def mixture_plan(D: int, N: int, C: int) -> DQPlan | None:
    """The launch plan of the mixture mode for ``N = S·C`` columns, or
    ``None`` where none exists: every column tile must hold whole states.
    Up to 64 columns :func:`dq_plan`'s one tile holds all of them; past
    that, tiles of ``8·tn`` columns with the largest ``tn ≤ 8`` that makes
    ``8·tn`` a multiple of C (C=4: 64 columns; C=3: 48; C=9, C=11 or
    C > 64: none)."""
    if C < 1 or N % C:
        return None
    if N <= 64:
        return dq_plan(D, N)
    tn = next((t for t in range(8, 0, -1) if 8 * t % C == 0), None)
    return None if tn is None else _plan(D, tn, -(-N // (8 * tn)))


def diag_quadratic_reference(
    obs: torch.Tensor, wq: torch.Tensor, wl: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain torch ``(obs²) @ wq + obs @ wl + bias``, squared in at least
    f32."""
    obs = obs.to(torch.promote_types(obs.dtype, torch.float32))
    return (obs * obs) @ wq + obs @ wl + bias


def diag_gmm_log_probs_reference(
    obs: torch.Tensor, wq: torch.Tensor, wl: torch.Tensor, bias: torch.Tensor,
    log_norm: torch.Tensor, log_w: torch.Tensor, C: int,
) -> torch.Tensor:
    """Plain torch ``logsumexp_c((log_norm - 0.5·diag_quadratic) + log_w)``
    over each state's C columns: ``(B, T, N / C)``."""
    comp = log_norm - 0.5 * diag_quadratic_reference(obs, wq, wl, bias) + log_w
    return logsumexp(comp.reshape(*comp.shape[:-1], -1, C), dim=-1)


def _check(obs, wq, wl, bias):
    """Raise unless the shapes are ``(B, T, D)``, ``(D, N)`` twice and
    ``(N,)``, none empty."""
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


def _launch(obs, wq, wl, bias, plan: DQPlan | None = None) -> torch.Tensor:
    """One launch of the CUDA kernel on ``plan`` (:func:`dq_plan` unless
    given), counted in ``diag_quadratic.launches``."""
    _check(obs, wq, wl, bias)
    _build.check_tensors("diag_quadratic", obs.device, obs=obs, wq=wq, wl=wl, bias=bias)
    B, T, D = obs.shape
    N = wq.shape[1]
    plan = dq_plan(D, N) if plan is None else plan
    out = torch.empty((B, T, N), dtype=torch.float32, device=obs.device)
    _LIB.launch("diag_quadratic_f32", "diag_quadratic", obs, wq, wl, bias, out, B * T, D, N,
                plan.tn, plan.col_tiles, int(plan.resident), plan.smem)
    diag_quadratic.launches += 1
    return out


def _forward(obs, wq, wl, bias) -> torch.Tensor:
    """The plain version on CPU tensors, else the kernel."""
    if obs.device.type == "cpu":
        return diag_quadratic_reference(obs, wq, wl, bias)
    with span("kernels.diag_quadratic"):
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
        with span("ops.diag_quadratic.backward"):
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
    with span("ops.diag_quadratic"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (obs, wq, wl, bias)):
            return _DiagQuadratic.apply(obs, wq, wl, bias)
        return _forward(obs, wq, wl, bias)


diag_quadratic.launches = 0
diag_quadratic.mixture_launches = 0


def diag_gmm_log_probs(
    obs: torch.Tensor,        # (B, T, D)
    wq: torch.Tensor,         # (D, N)  inv_var per component column, N = S·C
    wl: torch.Tensor,         # (D, N)  -2 μ·inv_var
    bias: torch.Tensor,       # (N,)    Σ μ²·inv_var
    log_norm: torch.Tensor,   # (N,)    each component's normalizer
    log_w: torch.Tensor,      # (N,)    each component's log mixture weight
    C: int,
) -> torch.Tensor:
    """``(B, T, S)`` = ``logsumexp_c((log_norm - 0.5·diag_quadratic) +
    log_w)`` over each state's C adjacent columns, with no gradient.

    CUDA tensors run row 1's kernel in its mixture mode, one launch on
    :func:`mixture_plan` (which must exist), counted in
    ``diag_quadratic.launches`` and ``diag_quadratic.mixture_launches``;
    the checks are :func:`diag_quadratic`'s. CPU tensors run
    :func:`diag_gmm_log_probs_reference`.
    """
    _check(obs, wq, wl, bias)
    B, T, D = obs.shape
    N = wq.shape[1]
    if log_norm.shape != (N,) or log_w.shape != (N,) or C < 1 or N % C:
        raise ValueError(
            f"diag_gmm_log_probs: log_norm {tuple(log_norm.shape)}, log_w "
            f"{tuple(log_w.shape)} for N={N} columns of C={C} components"
        )
    if obs.device.type == "cpu":
        return diag_gmm_log_probs_reference(obs, wq, wl, bias, log_norm, log_w, C)
    with span("kernels.diag_quadratic"):
        _build.check_tensors("diag_quadratic", obs.device, obs=obs, wq=wq, wl=wl, bias=bias,
                             log_norm=log_norm, log_w=log_w)
        plan = mixture_plan(D, N, C)
        if plan is None:
            raise ValueError(f"diag_gmm_log_probs: no column tiling holds whole states of "
                             f"C={C} at N={N}")
        out = torch.empty((B, T, N // C), dtype=torch.float32, device=obs.device)
        _LIB.launch("diag_gmm_f32", "diag_quadratic", obs, wq, wl, bias, log_norm, log_w, out,
                    B * T, D, N, C, plan.tn, plan.col_tiles, int(plan.resident), plan.smem)
        diag_quadratic.launches += 1
        diag_quadratic.mixture_launches += 1
        return out
