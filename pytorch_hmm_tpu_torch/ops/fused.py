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
the ``(B, T, S)`` scores never reach device memory. On CPU tensors it
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
from typing import Optional, Tuple

import torch

from .. import core
from ..core.semiring import logsumexp
from . import _build

__all__ = ["emission_tables", "fused_gmm_supported", "fused_gmm_viterbi",
           "fused_gmm_viterbi_reference"]

_LOG_2PI = math.log(2.0 * math.pi)
_LANES, _SUBLANES = 128, 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"fused_gmm_viterbi_f32": [_P] * 10 + [_I] * 6 + [_P]}


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
    a, bm, const = emission_tables(means, log_vars, log_w)
    # The kernel reads component-major, state-minor tables.
    a_tab = a.permute(1, 2, 0).contiguous()       # (C, D, S)
    b_tab = bm.permute(1, 2, 0).contiguous()
    cn = const.T.contiguous()                     # (C, S)
    lib = _build.load("fused_gmm", _SIGNATURES)
    psi = torch.empty((B, T, S), dtype=torch.uint8, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    rc = lib.fused_gmm_viterbi_f32(
        obs.data_ptr(), a_tab.data_ptr(), b_tab.data_ptr(), cn.data_ptr(), log_a.data_ptr(),
        log_pi.data_ptr(), None if lengths is None else lengths.data_ptr(), psi.data_ptr(),
        states.data_ptr(), score.data_ptr(), B, T, D, S, C, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "fused_gmm_viterbi")
    fused_gmm_viterbi.launches += 1
    return states, score


fused_gmm_viterbi.launches = 0
