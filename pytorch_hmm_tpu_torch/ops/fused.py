"""Fused diagonal-GMM emission and Viterbi decode in one launch.

Port of ``pytorch_hmm_tpu/ops/fused.py``. On CUDA tensors
:func:`fused_gmm_viterbi` launches the kernel in ``csrc/fused_gmm.cu``:
each sequence's features are scored against every state's C components
in matmul form::

    log N(x; mu_sc, diag(var_sc)) + log w_sc
      = const[s, c] + x² · A[:, s, c] + x · Bm[:, s, c]
    A = -1/(2 var),  Bm = mu/var,
    const = log w - (D log 2pi + Σ log var + Σ mu²/var) / 2

reduced over C by logsumexp and fed to the trellis in shared memory, so
the ``(B, T, S)`` scores never reach device memory; the kernel builds
the tables from the parameters itself, at the layout :func:`fused_plan`
picks for the shape. On CPU tensors it
runs :func:`fused_gmm_viterbi_reference`: the same matmul-form emission
in plain torch, ``logsumexp`` over C, ``core.viterbi``. The two differ
from the unfused decode (``emissions.gmm_log_probs`` into the trellis)
only by the summation order of the scores.

The envelope is the JAX package's (:func:`fused_gmm_supported`): diag
covariance, S ≤ 128 and ``next_pow2(C) · ceil8(S) ≤ 128``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import core
from ..core.semiring import logsumexp
from . import _build

__all__ = ["emission_tables", "fused_gmm_supported", "fused_gmm_viterbi",
           "fused_gmm_viterbi_reference", "fused_plan"]

_LOG_2PI = math.log(2.0 * math.pi)
_LANES, _SUBLANES = 128, 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Library("fused_gmm", {"fused_gmm_viterbi_f32": [_P] * 10 + [_F] + [_I] * 11 + [_P]})
# The phase probe: a separate build of csrc/fused_gmm.cu, never on an
# entry point's path (chip_smoke.py and kernel_ab.py read it).
PROBE_DEFINES = ("FUSED_GMM_PROBE",)
_PROBE_LIB = _build.Library(
    "fused_gmm", {"fused_gmm_probe_f32": [_P] * 11 + [_F] + [_I] * 11 + [_P]}, PROBE_DEFINES)

# The kernel's shared-memory plan (csrc/fused_gmm.cu, fused_bytes): frames
# a chunk, ring slots, the transposed rows' stride, the mbarriers' bytes,
# and what a block may hold beside the kernel's static shared memory.
_TC, _NS, _XS, _BAR_BYTES = 64, 2, 68, 80
SMEM_LIMIT = 232448 - 2048
# k-blocks tried below a whole D, largest first.
_KD_STEPS = (128, 64, 32, 16, 8, 4, 2, 1)


class FusedPlan(NamedTuple):
    """Shared memory of the fused decode at (S, C, D): ``kp`` the chain's
    padded states, ``sp`` the ring's row (S rounded up to 8), ``cp`` the
    padded components, ``n`` = sp cp table columns; features multiplied
    ``kd`` at a time; ``resident`` tables built whole for the launch
    (else rebuilt a k-block at a time); ``raw`` chunks staged by a bulk
    copy (else read in place); ``smem`` the dynamic bytes."""

    kp: int
    sp: int
    cp: int
    n: int
    kd: int
    resident: bool
    raw: bool
    smem: int


def fused_plan(num_states: int, num_components: int, feature_dim: int) -> FusedPlan:
    """The first layout that fits ``SMEM_LIMIT``: resident tables before
    streamed ones, a staged chunk before reads in place, then the largest
    k-block. The envelope (:func:`fused_gmm_supported`) always fits."""
    S, D = num_states, feature_dim
    kp = 32 if S <= 32 else 64 if S <= 64 else 128
    sp = -(-S // _SUBLANES) * _SUBLANES
    cp = _next_pow2(num_components)
    n = sp * cp
    fixed = _BAR_BYTES + 4 * (2 * kp + n + _NS * _TC * sp)
    kds = [D] + [k for k in _KD_STEPS if k < D]
    for resident in (True, False):
        for raw in (True, False):
            for kd in kds:
                smem = fixed + 4 * (2 * (D if resident else kd) * n + 2 * kd * _XS
                                    + (_TC * D if raw else 0))
                if smem <= SMEM_LIMIT:
                    return FusedPlan(kp, sp, cp, n, kd, resident, raw, smem)
    raise ValueError(f"fused_gmm_viterbi: no shared-memory plan for S={S}, C={num_components}, D={D}")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def fused_gmm_supported(num_states: int, num_components: int, covariance_type: str) -> bool:
    """Shapes the fused decode takes: the JAX kernel's envelope."""
    sg = -(-num_states // _SUBLANES) * _SUBLANES
    return (
        covariance_type == "diag"
        and num_states <= _LANES
        and _next_pow2(num_components) * sg <= _LANES
    )


def emission_tables(means: torch.Tensor, log_vars: torch.Tensor, log_w: torch.Tensor):
    """The matmul-form emission of ``(S, C, D)`` diag-GMM parameters:
    ``(A (S, C, D), Bm (S, C, D), const (S, C))``."""
    D = means.shape[-1]
    inv_var = torch.exp(-log_vars)
    a = -0.5 * inv_var
    bm = means * inv_var
    const = (log_w - 0.5 * (D * _LOG_2PI + torch.sum(log_vars, dim=-1))
             - 0.5 * torch.sum(means * means * inv_var, dim=-1))
    return a, bm, const


def _check(what, obs, means, log_vars, log_w, log_a, log_pi):
    if obs.ndim != 3 or means.ndim != 3:
        raise ValueError(f"{what}: obs (B, T, D) and means (S, C, D), got "
                         f"{tuple(obs.shape)} and {tuple(means.shape)}")
    S, C, D = means.shape
    if (tuple(log_vars.shape) != (S, C, D) or tuple(log_w.shape) != (S, C)
            or obs.shape[-1] != D or tuple(log_a.shape) != (S, S)
            or tuple(log_pi.shape) != (S,)):
        raise ValueError(
            f"{what}: means {tuple(means.shape)} needs log_vars ({S}, {C}, {D}), log_w "
            f"({S}, {C}), obs (B, T, {D}), log_a ({S}, {S}) and log_pi ({S},); got "
            f"{tuple(log_vars.shape)}, {tuple(log_w.shape)}, {tuple(obs.shape)}, "
            f"{tuple(log_a.shape)}, {tuple(log_pi.shape)}"
        )
    if not fused_gmm_supported(S, C, "diag"):
        raise ValueError(f"{what}: S={S}, C={C} is outside the fused envelope "
                         "(S <= 128, next_pow2(C) * ceil8(S) <= 128)")
    return S, C, D


def fused_gmm_viterbi_reference(
    obs: torch.Tensor,
    means: torch.Tensor,
    log_vars: torch.Tensor,
    log_w: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: matmul-form emission, logsumexp over C,
    ``core.viterbi``."""
    S, C, D = _check("fused_gmm_viterbi", obs, means, log_vars, log_w, log_a, log_pi)
    a, bm, const = emission_tables(means, log_vars, log_w)
    scores = ((obs * obs) @ a.reshape(S * C, D).T + obs @ bm.reshape(S * C, D).T
              + const.reshape(S * C))
    log_obs = logsumexp(scores.reshape(*obs.shape[:2], S, C), dim=-1)
    return core.viterbi(log_obs, log_a, log_pi, lengths)


def fused_gmm_viterbi(
    obs: torch.Tensor,
    means: torch.Tensor,
    log_vars: torch.Tensor,
    log_w: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-launch diag-GMM-HMM Viterbi decode.

    Args: ``obs (B, T, D)`` features; ``means``, ``log_vars (S, C, D)``
    diag component parameters; ``log_w (S, C)`` log mixture weights;
    ``log_a (S, S)``, ``log_pi (S,)``; optional ``lengths (B,)``. Returns
    ``(states (B, T) int32, score (B,))``.

    CUDA tensors run the kernel (counted in ``fused_gmm_viterbi.launches``):
    float32 and contiguous, ``lengths`` int32, all on one device, inside
    :func:`fused_gmm_supported`; anything else raises. CPU tensors run
    the plain version.
    """
    if obs.device.type == "cpu":
        return fused_gmm_viterbi_reference(obs, means, log_vars, log_w, log_a, log_pi, lengths)
    S, C, D = _check("fused_gmm_viterbi", obs, means, log_vars, log_w, log_a, log_pi)
    B, T, _ = obs.shape
    dev = obs.device
    _build.check_tensors("fused_gmm_viterbi", dev, obs=obs, means=means, log_vars=log_vars,
                         log_w=log_w, log_a=log_a, log_pi=log_pi)
    if B == 0 or T == 0:
        raise ValueError(f"fused_gmm_viterbi: empty input {tuple(obs.shape)}")
    if lengths is not None and (lengths.device != dev or lengths.dtype != torch.int32
                                or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError(f"fused_gmm_viterbi: lengths must be contiguous int32 ({B},) on {dev}")
    states, score = _launch(obs, means, log_vars, log_w, log_a, log_pi, lengths)
    fused_gmm_viterbi.launches += 1
    return states, score


def _launch(obs, means, log_vars, log_w, log_a, log_pi, lengths, probe=None):
    """Launch ``csrc/fused_gmm.cu`` on checked CUDA inputs at
    :func:`fused_plan`'s layout; the kernel builds its tables from the
    parameters. With ``probe`` (an int64 ``(B, ceil(T / 64), 10)``
    tensor) the probe build instead, which writes each role's cycles
    there."""
    B, T, D = obs.shape
    S, C, _ = means.shape
    dev = obs.device
    plan = fused_plan(S, C, D)
    psi = torch.empty((B, T, S), dtype=torch.uint8, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    args = (obs, means, log_vars, log_w, log_a, log_pi, lengths, psi, states, score)
    tail = (D * _LOG_2PI, B, T, D, S, C, plan.cp, plan.kd, int(plan.resident), int(plan.raw),
            plan.smem)
    if probe is None:
        _LIB.launch("fused_gmm_viterbi_f32", "fused_gmm_viterbi", *args, *tail)
    else:
        _PROBE_LIB.launch("fused_gmm_probe_f32", "fused_gmm_viterbi", *args, probe, *tail)
    return states, score


fused_gmm_viterbi.launches = 0
