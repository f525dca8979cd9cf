"""Viterbi decoding as a plain torch loop (max-product semiring).

Port of ``pytorch_hmm_tpu.core.viterbi.viterbi`` for static ``(K, K)``
and time-varying ``(B, T, K, K)`` transitions. The add order per frame
is the reference's — ``max_k(delta[k] + log_a[k, j]) + log_obs[t, j]``
— so paths and scores are bit-identical to it, ties included (lowest
predecessor index). This is the plain version the CUDA trellis kernel
(``ops.smallk.smallk_viterbi``) is held against. The reference's
``viterbi_associative`` and ``viterbi_blocked`` (static only, used by
``hmm.py``) come with ROADMAP queue 1 item 5.
"""

from __future__ import annotations

from typing import Optional

import torch

from .semiring import max_matvec

__all__ = ["viterbi"]


def viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    return_score: bool = True,
):
    """Most-likely state path.

    Args:
        log_obs: ``(B, T, K)`` per-state observation log-likelihoods.
        log_a: ``(K, K)`` static or ``(B, T, K, K)`` time-varying log
            transitions (entry ``[:, t]`` governs the step into frame
            ``t``; ``[:, 0]`` is ignored).
        log_pi: ``(K,)`` initial log-probabilities.
        lengths: optional ``(B,)`` valid lengths; the path for padded
            frames repeats the row's final valid state.
        return_score: also return the path log-score.

    Returns:
        ``states (B, T) int32`` and, if requested, ``score (B,)`` — the
        log joint probability of the best path.
    """
    B, T, K = log_obs.shape
    tv = log_a.ndim != 2
    if tv and tuple(log_a.shape) != (B, T, K, K):
        raise ValueError(
            f"viterbi takes (K, K) or (B, T, K, K) = {(B, T, K, K)} transitions, "
            f"got {tuple(log_a.shape)}"
        )
    states_k = torch.arange(K, device=log_obs.device)
    delta = log_pi + log_obs[:, 0]
    psis = []
    for t in range(1, T):
        best, psi = max_matvec(delta, log_a[:, t] if tv else log_a)
        best = best + log_obs[:, t]
        if lengths is not None:
            keep = (t < lengths)[:, None]
            best = torch.where(keep, best, delta)
            # Pad frames point at themselves, so the backtrace repeats
            # the last valid state through them.
            psi = torch.where(keep, psi, states_k)
        delta = best
        psis.append(psi)

    score, state = delta.max(dim=-1)
    states = torch.empty((B, T), dtype=torch.int64, device=log_obs.device)
    states[:, T - 1] = state
    for t in range(T - 1, 0, -1):
        state = psis[t - 1].gather(1, state[:, None])[:, 0]
        states[:, t - 1] = state
    states = states.to(torch.int32)
    if return_score:
        return states, score
    return states
