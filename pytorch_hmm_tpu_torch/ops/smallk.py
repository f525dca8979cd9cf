"""Small-K Viterbi decode (the decode path's trellis).

Port of ``pytorch_hmm_tpu/ops/smallk.py``. On CUDA tensors
:func:`smallk_viterbi` launches the hand-written kernel in
``csrc/smallk_viterbi.cu``: one warp per sequence, trellis and
backtrace in one launch, any batch size, static ``(K, K)`` or
time-varying ``(B, T, K, K)`` transitions. On CPU tensors it runs
:func:`smallk_viterbi_reference`, the ported ``core.viterbi``. Both give
the same paths and scores as ``pytorch_hmm_tpu.core.viterbi``, ties
(lowest state index) and ragged padding included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from . import _build

__all__ = ["smallk_viterbi", "smallk_viterbi_reference", "smallk_supported",
           "check_problem", "MAX_SMALLK"]

# One warp lane per state.
MAX_SMALLK = 32

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_SIGNATURES = {"smallk_viterbi_f32": _ARGS, "smallk_viterbi_tv_f32": _ARGS}


def smallk_supported(num_states: int, batch: Optional[int] = None) -> bool:
    """True when the CUDA trellis kernel takes ``num_states`` states.
    ``batch`` is the JAX package's batch gate (its kernel tiles the batch
    on lanes); the CUDA kernel runs a block per sequence at any batch, so
    it is accepted and unused."""
    return 1 <= num_states <= MAX_SMALLK


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
    B, T, K, lengths = check_problem("smallk_viterbi", log_obs, log_a, log_pi, lengths,
                                     time_varying=True)
    _build.check_tensors("smallk_viterbi", log_obs.device,
                         log_obs=log_obs, log_a=log_a, log_pi=log_pi)
    dev = log_obs.device
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)

    lib = _build.load("smallk_viterbi", _SIGNATURES)
    tv = log_a.ndim == 4
    psi = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    launch = lib.smallk_viterbi_tv_f32 if tv else lib.smallk_viterbi_f32
    rc = launch(
        log_obs.data_ptr(), log_a.data_ptr(), log_pi.data_ptr(),
        lengths.data_ptr(), psi.data_ptr(), states.data_ptr(),
        score.data_ptr(), B, T, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "smallk_viterbi")
    smallk_viterbi.launches += 1
    smallk_viterbi.time_varying_launches += tv
    return states, score


smallk_viterbi.launches = 0
smallk_viterbi.time_varying_launches = 0
