"""Forward, backward and Viterbi chains for more than 32 states.

Port of the log-space kernels of ``pytorch_hmm_tpu/ops/scan.py``:
``pallas_forward``, ``pallas_backward`` and ``pallas_viterbi``. On CUDA
tensors each launches its kernel in ``csrc/scan_bigk.cu`` (one block per
sequence, any K up to 1024, static ``(K, K)`` transitions, optional
``lengths``); on CPU tensors it runs its plain version here. The
dispatch (``ops.auto_*``) sends ``33 <= K <= 1024`` to them
(:func:`scan_supported`); K ≤ 32 goes to the small-K kernels.

The sum chains compute what the TPU kernels compute, in the scaling
form::

    alpha_t = lo_t + c + log(exp(alpha_{t-1} - c) @ exp(log_a)),  c = max alpha_{t-1}
    beta_t  = c + log(exp(lo_{t+1} + beta_{t+1} - c) @ exp(log_a).T),  c >= -1e30

so a state reached only through mass below ``e^-87`` of the frame's
largest gets ``-inf``, where the logsumexp ``core`` gives a finite
value; posteriors agree. The plain versions run the same prob-space
step as a T-step loop, so the card comparison is tight. The Viterbi's
plain version is ``core.viterbi``: paths and scores are bit-identical,
lowest-index ties included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from . import _build
from .smallk import MAX_SMALLK, check_problem

__all__ = [
    "MAX_K",
    "pallas_backward",
    "pallas_backward_reference",
    "pallas_forward",
    "pallas_forward_reference",
    "pallas_viterbi",
    "pallas_viterbi_reference",
    "scan_supported",
]

# The JAX package's state bound for these kernels (``ops/__init__.py``
# ``_MAX_K``); the CUDA kernels take any K up to it.
MAX_K = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "scan_bigk_forward_f32": [_P] * 5 + [_I] * 4 + [_P],
    "scan_bigk_backward_f32": [_P] * 4 + [_I] * 4 + [_P],
    "scan_bigk_viterbi_f32": [_P] * 7 + [_I] * 4 + [_P],
}


def scan_supported(num_states: int) -> bool:
    """True when the dispatch sends ``num_states`` states to these
    kernels: more than the small-K kernels take, at most ``MAX_K``."""
    return MAX_SMALLK < num_states <= MAX_K


def _launch_args(what, log_obs, log_a, log_pi, lengths):
    B, T, K, lengths = check_problem(what, log_obs, log_a, log_pi, lengths, max_states=MAX_K)
    tensors = {"log_obs": log_obs, "log_a": log_a}
    if log_pi is not None:
        tensors["log_pi"] = log_pi
    _build.check_tensors(what, log_obs.device, **tensors)
    dev = log_obs.device
    ln_ptr = None if lengths is None else lengths.data_ptr()
    return B, T, K, dev, ln_ptr, torch.cuda.current_stream(dev).cuda_stream


def pallas_forward_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's prob-space step as a T-step loop."""
    pa = torch.exp(log_a)
    alpha = log_pi + log_obs[:, 0]
    out = [alpha]
    for t in range(1, log_obs.shape[1]):
        c = alpha.amax(dim=-1, keepdim=True)
        nxt = (log_obs[:, t] + c) + torch.log(torch.exp(alpha - c) @ pa)
        if lengths is not None:
            nxt = torch.where((t < lengths)[:, None], nxt, alpha)
        out.append(nxt)
        alpha = nxt
    log_alpha = torch.stack(out, 1)
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=-1)


def pallas_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward algorithm: ``(log_alpha (B, T, K), log_z (B,))``; with
    ``lengths (B,)`` each row's alpha is frozen from its end on, so
    ``log_z`` is the logsumexp of its last valid frame.

    CUDA tensors run the kernel (counted in ``pallas_forward.launches``):
    float32 and contiguous, ``lengths`` int32, 1 ≤ K ≤ 1024, all on one
    device; anything else raises. CPU tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return pallas_forward_reference(log_obs, log_a, log_pi, lengths)
    B, T, K, dev, ln_ptr, stream = _launch_args("pallas_forward", log_obs, log_a, log_pi, lengths)
    lib = _build.load("scan_bigk", _SIGNATURES)
    pa = torch.exp(log_a).contiguous()
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    rc = lib.scan_bigk_forward_f32(log_obs.data_ptr(), pa.data_ptr(), log_pi.data_ptr(), ln_ptr,
                                   alpha.data_ptr(), B, T, K, dev.index, stream)
    _build.check(rc, "pallas_forward")
    pallas_forward.launches += 1
    return alpha, torch.logsumexp(alpha[:, -1], dim=-1)


pallas_forward.launches = 0


def pallas_backward_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: the kernel's prob-space step as a T-step loop."""
    B, T, K = log_obs.shape
    pa_t = torch.exp(log_a).T
    beta = torch.zeros((B, K), dtype=log_obs.dtype, device=log_obs.device)
    out = [beta]
    for t in range(T - 2, -1, -1):
        v = log_obs[:, t + 1] + beta
        c = v.amax(dim=-1, keepdim=True).clamp_min(core.LOG_ZERO)
        nxt = c + torch.log(torch.exp(v - c) @ pa_t)
        if lengths is not None:
            nxt = torch.where((t < lengths - 1)[:, None], nxt, torch.zeros_like(nxt))
        out.append(nxt)
        beta = nxt
    return torch.stack(out[::-1], 1)


def pallas_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward algorithm: ``log_beta (B, T, K)``, 0 from each row's
    frame ``lengths[b] - 1`` on. Launch rules as :func:`pallas_forward`
    (counted in ``pallas_backward.launches``)."""
    if log_obs.device.type == "cpu":
        return pallas_backward_reference(log_obs, log_a, lengths)
    B, T, K, dev, ln_ptr, stream = _launch_args("pallas_backward", log_obs, log_a, None, lengths)
    lib = _build.load("scan_bigk", _SIGNATURES)
    pa_t = torch.exp(log_a).T.contiguous()
    beta = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    rc = lib.scan_bigk_backward_f32(log_obs.data_ptr(), pa_t.data_ptr(), ln_ptr, beta.data_ptr(),
                                    B, T, K, dev.index, stream)
    _build.check(rc, "pallas_backward")
    pallas_backward.launches += 1
    return beta


pallas_backward.launches = 0


def pallas_viterbi_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the ported ``core.viterbi``."""
    return core.viterbi(log_obs, log_a, log_pi, lengths)


def pallas_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Viterbi: ``(states (B, T) int32, score (B,))``, the same
    paths and scores as ``core.viterbi``, ties and ragged padding
    included. Launch rules as :func:`pallas_forward` (counted in
    ``pallas_viterbi.launches``)."""
    if log_obs.device.type == "cpu":
        return pallas_viterbi_reference(log_obs, log_a, log_pi, lengths)
    B, T, K, dev, ln_ptr, stream = _launch_args("pallas_viterbi", log_obs, log_a, log_pi, lengths)
    lib = _build.load("scan_bigk", _SIGNATURES)
    psi = torch.empty((B, T, K), dtype=torch.int16, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    rc = lib.scan_bigk_viterbi_f32(log_obs.data_ptr(), log_a.data_ptr(), log_pi.data_ptr(), ln_ptr,
                                   psi.data_ptr(), states.data_ptr(), score.data_ptr(),
                                   B, T, K, dev.index, stream)
    _build.check(rc, "pallas_viterbi")
    pallas_viterbi.launches += 1
    return states, score


pallas_viterbi.launches = 0
