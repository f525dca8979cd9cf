"""Small-K Viterbi decode (the decode path's trellis).

Port of ``pytorch_hmm_tpu/ops/smallk.py``. On CUDA tensors
:func:`smallk_viterbi` launches the hand-written kernel in
``csrc/smallk_viterbi.cu``: one warp per sequence, trellis and
backtrace in one launch, any batch size, static ``(K, K)`` or
time-varying ``(B, T, K, K)`` transitions. On CPU tensors it runs
:func:`smallk_viterbi_reference`, the ported ``core.viterbi``, which gives
the same paths and scores as ``pytorch_hmm_tpu.core.viterbi``, ties
(lowest state index) and ragged padding included. The kernel keeps the
same tie and padding rules but runs its chain bounded: each frame is
shifted by its largest score and the chain renormalised once a staged
chunk, what was taken out summed in double. Its scores are closer to
the exact ones than the plain float32 chain's, which drift with T, and
its paths are the plain version's except on ties within that drift.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from ..trace import span
from . import _build
from ._build import MAX_SMALLK, check_problem

__all__ = ["smallk_viterbi", "smallk_viterbi_reference", "smallk_supported",
           "check_problem", "MAX_SMALLK"]

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_LIB = _build.Library("smallk_viterbi",
                      {"smallk_viterbi_f32": _ARGS, "smallk_viterbi_tv_f32": _ARGS})


def smallk_supported(num_states: int, batch: Optional[int] = None) -> bool:
    """True when the CUDA trellis kernel takes ``num_states`` states.
    ``batch`` is the JAX package's batch gate (its kernel tiles the batch
    on lanes); the CUDA kernel runs a block per sequence at any batch, so
    it is accepted and unused."""
    return 1 <= num_states <= MAX_SMALLK


def smallk_viterbi_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the ported ``core.viterbi``."""
    return core.viterbi(log_obs, log_a, log_pi, lengths)


def smallk_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched Viterbi for K ≤ 32 states.

    Args: ``(B, T, K)`` log-obs, static ``(K, K)`` or time-varying
    ``(B, T, K, K)`` log transitions (entry ``[:, t]`` governs the step
    into frame ``t``; ``[:, 0]`` is never read), ``(K,)`` log prior,
    optional ``(B,)`` lengths. Returns ``(states (B, T) int32, score (B,)
    float32)``.

    CUDA tensors run the kernel (counted in ``smallk_viterbi.launches``,
    the time-varying mode also in ``smallk_viterbi.time_varying_launches``):
    float32 and contiguous, ``lengths`` int32, all on one device; anything
    else raises. CPU tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return smallk_viterbi_reference(log_obs, log_a, log_pi, lengths)
    with span("kernels.smallk_viterbi"):
        B, T, K, lengths = check_problem("smallk_viterbi", log_obs, log_a, log_pi, lengths,
                                         time_varying=True)
        _build.check_tensors("smallk_viterbi", log_obs.device,
                             log_obs=log_obs, log_a=log_a, log_pi=log_pi)
        dev = log_obs.device
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=dev)

        tv = log_a.ndim == 4
        psi = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
        states = torch.empty((B, T), dtype=torch.int32, device=dev)
        score = torch.empty((B,), dtype=torch.float32, device=dev)
        _LIB.launch("smallk_viterbi_tv_f32" if tv else "smallk_viterbi_f32", "smallk_viterbi",
                    log_obs, log_a, log_pi, lengths, psi, states, score, B, T, K)
    smallk_viterbi.launches += 1
    smallk_viterbi.time_varying_launches += tv
    return states, score


smallk_viterbi.launches = 0
smallk_viterbi.time_varying_launches = 0
