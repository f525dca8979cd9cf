"""Small-K HMM forward and backward sum recursions.

Port of ``pytorch_hmm_tpu/ops/hsmm_smallk.py``'s ``hsmm_smallk_forward``
and ``hsmm_smallk_backward`` for the maximum duration the training path
uses, D = 1: an HSMM whose segments last one frame is an HMM, and the
two kernels are its forward and backward sum recursions (the primal
and the VJP of ``ops.pallas_log_likelihood``). ``log_dur[:, 0]`` is
honoured as a per-state constant added to every frame.

On CUDA tensors (K ≤ 32) the wrappers launch the hand-written kernels
of ``csrc/smallk_sum.cu``; on CPU tensors they run the plain versions,
``core.fb.forward_log`` / ``backward_log`` with ``log_dur[:, 0]`` folded
into ``log_obs``. A duration D > 1 raises on either device: the
general-D duration ring comes with ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from . import _build
from .smallk import MAX_SMALLK, check_problem

__all__ = [
    "hsmm_smallk_forward",
    "hsmm_smallk_backward",
    "hsmm_smallk_forward_reference",
    "hsmm_smallk_backward_reference",
    "hsmm_smallk_supported",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "hmm_forward_sum_f32": [_P] * 7 + [_I] * 4 + [_P],
    "hmm_backward_sum_f32": [_P] * 6 + [_I] * 4 + [_P],
}


def hsmm_smallk_supported(num_states: int, max_duration: int, batch: int) -> bool:
    """True when the CUDA kernels take the problem: 1 ≤ S ≤ 32 states,
    duration D = 1, any batch."""
    return 1 <= num_states <= MAX_SMALLK and max_duration == 1


def _check_duration(log_dur: torch.Tensor) -> None:
    if log_dur.ndim != 2 or log_dur.shape[-1] != 1:
        raise NotImplementedError(
            f"hsmm_smallk at log_dur {tuple(log_dur.shape)}: only duration D = 1 "
            "(log_dur (S, 1)) is ported; general D is ROADMAP queue 1 item 6 "
            "(duration models, kernel rows 4-7)"
        )


def hsmm_smallk_forward_reference(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Plain version: ``core.fb.forward_log`` of ``log_obs + log_dur[:, 0]``."""
    _check_duration(log_dur)
    return core.fb.forward_log(log_obs + log_dur[:, 0], log_a, log_pi, lengths)


def hsmm_smallk_backward_reference(log_obs, log_a, log_dur, lengths=None):
    """Plain version: ``beta* = core.fb.backward_log`` of
    ``log_obs + log_dur[:, 0]``, and ``beta_start = log_obs + log_dur[:, 0]
    + beta*``."""
    _check_duration(log_dur)
    lo = log_obs + log_dur[:, 0]
    beta = core.fb.backward_log(lo, log_a, lengths)
    return beta, lo + beta


def hsmm_smallk_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM forward at D = 1: ``(log_alpha (B, T, S), log_z (B,))``.

    Alpha is causal, so ragged rows are exact on their valid frames and
    ``log_z`` takes each row's frame ``lengths[b] - 1``; later frames are
    unspecified (the kernel runs on through them). CUDA tensors run the
    kernel (counted in ``hsmm_smallk_forward.launches``): float32 and
    contiguous, ``lengths`` int32, all on one device; anything else
    raises. CPU tensors run the plain version.
    """
    _check_duration(log_dur)
    if log_obs.device.type == "cpu":
        return hsmm_smallk_forward_reference(log_obs, log_a, log_pi, log_dur, lengths)
    B, T, K, lengths = check_problem("hsmm_smallk_forward", log_obs, log_a, log_pi, lengths)
    ld0 = log_dur[:, 0].contiguous()
    _build.check_tensors("hsmm_smallk_forward", log_obs.device, log_obs=log_obs,
                         log_a=log_a, log_pi=log_pi, log_dur=ld0)
    dev = log_obs.device
    ln_ptr = None if lengths is None else lengths.data_ptr()
    lib = _build.load("smallk_sum", _SIGNATURES)
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    rc = lib.hmm_forward_sum_f32(
        log_obs.data_ptr(), log_a.data_ptr(), log_pi.data_ptr(), ld0.data_ptr(),
        ln_ptr, alpha.data_ptr(), log_z.data_ptr(), B, T, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "hsmm_smallk_forward")
    hsmm_smallk_forward.launches += 1
    return alpha, log_z


def hsmm_smallk_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM backward at D = 1: ``(log_beta_star, log_beta_start)``, each
    ``(B, T, S)``. ``beta*`` is the HMM's beta (0 from each row's frame
    ``lengths[b] - 1`` on); ``beta_start = log_obs + log_dur[:, 0] +
    beta*`` on valid frames. CUDA tensors run the kernel (counted in
    ``hsmm_smallk_backward.launches``), CPU tensors the plain version.
    """
    _check_duration(log_dur)
    if log_obs.device.type == "cpu":
        return hsmm_smallk_backward_reference(log_obs, log_a, log_dur, lengths)
    B, T, K, lengths = check_problem("hsmm_smallk_backward", log_obs, log_a, None, lengths)
    ld0 = log_dur[:, 0].contiguous()
    _build.check_tensors("hsmm_smallk_backward", log_obs.device, log_obs=log_obs,
                         log_a=log_a, log_dur=ld0)
    dev = log_obs.device
    ln_ptr = None if lengths is None else lengths.data_ptr()
    lib = _build.load("smallk_sum", _SIGNATURES)
    beta_star = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    beta_start = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    rc = lib.hmm_backward_sum_f32(
        log_obs.data_ptr(), log_a.data_ptr(), ld0.data_ptr(), ln_ptr,
        beta_star.data_ptr(), beta_start.data_ptr(), B, T, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "hsmm_smallk_backward")
    hsmm_smallk_backward.launches += 1
    return beta_star, beta_start


hsmm_smallk_forward.launches = 0
hsmm_smallk_backward.launches = 0
