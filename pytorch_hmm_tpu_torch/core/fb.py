"""Log-domain forward-backward as plain torch code.

Port of ``pytorch_hmm_tpu/core/fb.py``, with its two formulations:

* ``method="scan"``: the sequential recursion, one Python step per
  frame. The numerics ground truth, and the plain version every
  sum-semiring CUDA kernel of the package is held against.
* ``method="associative"``: a parallel-in-time prefix scan in the
  ``(logsumexp, +)`` matrix semiring (Särkkä & García-Fernández,
  arXiv:2102.05743), O(log T) depth; equal to the scan up to the
  reassociation of the sums.

``log_obs`` is ``(B, T, K)``; ``log_a`` is static ``(K, K)`` or
time-varying ``(B, T, K, K)`` (entry ``[:, t]`` governs the step from
``t-1`` into ``t``; ``[:, 0]`` is ignored); ``log_pi`` is ``(K,)`` or
``(B, K)``. Optional ``lengths (B,)`` freeze each row past its end, as
the JAX package does: alpha keeps its last valid value, and
``beta_t = 0`` for ``t >= lengths[b] - 1``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .semiring import LOG_ZERO, log_matmul, log_matvec, log_matvec_t, logsumexp

__all__ = [
    "forward_log",
    "backward_log",
    "forward_backward",
    "log_likelihood",
    "xi_expectations",
    "xi_sum",
]


def _time_varying(log_a: torch.Tensor) -> bool:
    return log_a.ndim >= 3


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x (B, T, K)`` and ``idx (B,)``."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def _final_log_z(log_alpha: torch.Tensor, lengths) -> torch.Tensor:
    if lengths is None:
        return logsumexp(log_alpha[:, -1], dim=-1)
    return logsumexp(_gather_time(log_alpha, lengths - 1), dim=-1)


def _step_matrices(log_obs: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """``M_t[i, j] = log_a[i, j] + log_obs[t, j]`` for ``t >= 1``:
    ``(B, T-1, K, K)``."""
    la = log_a[:, 1:] if _time_varying(log_a) else log_a[None, None]
    return la + log_obs[:, 1:, None, :]


def _identity_where(m: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """Replace the step matrices of padded frames by the semiring
    identity (diagonal 0, off-diagonal a finite ``LOG_ZERO``)."""
    K = m.shape[-1]
    eye = torch.full((K, K), LOG_ZERO, dtype=m.dtype, device=m.device)
    eye.fill_diagonal_(0.0)
    return torch.where(pad[:, :, None, None], eye, m)


def _prefix_scan(m: torch.Tensor, combine: Callable, reverse: bool) -> torch.Tensor:
    """Inclusive scan over axis 1 by recursive doubling: element ``t``
    becomes ``m_0 ∘ … ∘ m_t`` (or ``m_t ∘ … ∘ m_{T-1}`` when
    ``reverse``), in O(log T) rounds of batched combines."""
    T = m.shape[1]
    off = 1
    while off < T:
        joined = combine(m[:, :-off], m[:, off:])
        if reverse:
            m = torch.cat([joined, m[:, T - off:]], 1)
        else:
            m = torch.cat([m[:, :off], joined], 1)
        off *= 2
    return m


def _forward_associative(log_obs, log_a, la0, lengths=None):
    B, T, K = log_obs.shape
    # A rank-1 first element whose rows all equal alpha_0: row 0 of each
    # prefix product is then log alpha_t.
    m0 = la0[:, None, None, :].expand(B, 1, K, K)
    m = torch.cat([m0, _step_matrices(log_obs, log_a)], 1)
    if lengths is not None:
        pad = torch.arange(T, device=log_obs.device)[None, :] >= lengths[:, None]
        m = _identity_where(m, pad)
    return _prefix_scan(m, log_matmul, reverse=False)[:, :, 0, :]


def _backward_associative(log_obs, log_a, lengths=None):
    B, T, K = log_obs.shape
    m = _step_matrices(log_obs, log_a)
    if lengths is not None:
        # m[t-1] is the step into frame t: padded frames become
        # identities, so beta_t = 0 for t >= lengths[b] - 1.
        pad = torch.arange(1, T, device=log_obs.device)[None, :] >= lengths[:, None]
        m = _identity_where(m, pad)
    # A final all-zero element: column 0 of each suffix product is beta_t.
    ones = torch.zeros((B, 1, K, K), dtype=log_obs.dtype, device=log_obs.device)
    m = torch.cat([m, ones], 1)
    return _prefix_scan(m, log_matmul, reverse=True)[:, :, :, 0]


def _as_lengths(lengths, device):
    if lengths is None:
        return None
    return torch.as_tensor(lengths).to(device=device, dtype=torch.long)


def forward_log(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    method: str = "scan",
):
    """Forward algorithm: ``(log_alpha (B, T, K), log_z (B,))``, with
    ``log_z`` the sequence log-likelihood up to each row's end."""
    lengths = _as_lengths(lengths, log_obs.device)
    la0 = log_pi + log_obs[:, 0]
    if method == "associative":
        log_alpha = _forward_associative(log_obs, log_a, la0, lengths)
    else:
        tv = _time_varying(log_a)
        alphas = [la0]
        la = la0
        for t in range(1, log_obs.shape[1]):
            nxt = log_obs[:, t] + log_matvec(la, log_a[:, t] if tv else log_a)
            if lengths is not None:
                nxt = torch.where((t < lengths)[:, None], nxt, la)
            alphas.append(nxt)
            la = nxt
        log_alpha = torch.stack(alphas, 1)
    return log_alpha, _final_log_z(log_alpha, lengths)


def backward_log(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    method: str = "scan",
) -> torch.Tensor:
    """Backward algorithm: ``log_beta (B, T, K)``, with
    ``beta_t[i] = logsumexp_j(log_a[i, j] + log_obs[t+1, j] + beta_{t+1}[j])``
    and ``beta_{T-1} = 0`` (``beta_t = 0`` for ``t >= lengths[b] - 1``)."""
    lengths = _as_lengths(lengths, log_obs.device)
    if method == "associative":
        return _backward_associative(log_obs, log_a, lengths)
    B, T, K = log_obs.shape
    tv = _time_varying(log_a)
    lb = torch.zeros((B, K), dtype=log_obs.dtype, device=log_obs.device)
    betas = [lb]
    for t in range(T - 2, -1, -1):
        nxt = log_matvec_t(log_a[:, t + 1] if tv else log_a, log_obs[:, t + 1] + lb)
        if lengths is not None:
            nxt = torch.where((t < lengths - 1)[:, None], nxt, torch.zeros_like(nxt))
        betas.append(nxt)
        lb = nxt
    return torch.stack(betas[::-1], 1)


def forward_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    method: str = "scan",
):
    """``(log_gamma, log_alpha, log_beta, log_z)``; ``log_gamma`` is the
    normalized state posterior ``log p(s_t | o)``."""
    log_alpha, log_z = forward_log(log_obs, log_a, log_pi, lengths, method)
    log_beta = backward_log(log_obs, log_a, lengths, method)
    lg = log_alpha + log_beta
    log_gamma = lg - logsumexp(lg, dim=-1, keepdim=True)
    return log_gamma, log_alpha, log_beta, log_z


def log_likelihood(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    method: str = "scan",
) -> torch.Tensor:
    """Sequence log-likelihood ``log p(o_1..o_T)`` of shape ``(B,)``."""
    return forward_log(log_obs, log_a, log_pi, lengths, method)[1]


def xi_expectations(
    log_alpha: torch.Tensor,
    log_beta: torch.Tensor,
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_z: torch.Tensor,
) -> torch.Tensor:
    """Log of the pairwise posteriors ``p(s_t=i, s_{t+1}=j | o)`` summed
    over t: ``(B, K, K)``, the E-step statistic of the transitions."""
    la = log_a[:, 1:] if _time_varying(log_a) else log_a[None, None]
    lxi = (
        log_alpha[:, :-1, :, None]
        + la
        + (log_obs + log_beta)[:, 1:, None, :]
        - log_z[:, None, None, None]
    )
    return logsumexp(lxi, dim=1)


def xi_sum(
    log_alpha: torch.Tensor,
    log_beta: torch.Tensor,
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``Σ_b w_b Σ_t ξ_bt`` in probability space, ``(K, K)``, for static
    ``(K, K)`` transitions, without the ``(B, T-1, K, K)`` table that
    :func:`xi_expectations` forms (0.52 GB at B=32, T=1000, K=64).

    ``ξ_t[i, j] ∝ exp(alpha_t[i]) P[i, j] exp(log_obs_{t+1}[j] +
    beta_{t+1}[j])`` factors into two shifted tables per frame,
    ``A_t = exp(alpha_t - max alpha_t)`` and ``N_t = exp((log_obs +
    beta)_{t+1} - max)``, each at most 1; the sum over (b, t) is ``P ⊙
    (Aᵀ diag(w / z) N)``, one ``(K, B·T) @ (B·T, K)`` product, where
    ``z_t = A_t P N_tᵀ`` normalizes each frame's ξ to 1. That is the
    forward-backward identity ``Σ_ij ξ_t[i, j] = 1``; taking it per frame
    instead of dividing by ``Z`` cancels the rounding that f32 alpha and
    beta accumulate over T frames, which is common to a frame's states
    (at K=64, T=1000 it put 5e-3 into the gradients, the per-frame form
    1e-12 into γ). A frame whose ``z_t`` underflows (no transition joins
    its likeliest states and every path between them lies beyond 87
    nats) contributes nothing.

    ``weights (B,)`` scales each sequence (the likelihood gradient's
    cotangent); ``lengths (B,)`` keep only transitions into frames
    ``t + 1 < lengths[b]``.
    """
    K = log_a.shape[-1]
    a = log_alpha[:, :-1]
    q = (log_obs + log_beta)[:, 1:]
    ea = torch.exp(a - a.amax(dim=-1, keepdim=True).clamp_min(LOG_ZERO))
    eq = torch.exp(q - q.amax(dim=-1, keepdim=True).clamp_min(LOG_ZERO))
    p = torch.exp(log_a)
    z = torch.sum(ea * (eq @ p.T), dim=-1, keepdim=True)
    w = torch.where(z > 0, 1.0 / z, torch.zeros_like(z))
    if weights is not None:
        w = w * weights[:, None, None]
    if lengths is not None:
        T = log_obs.shape[1]
        keep = torch.arange(1, T, device=w.device)[None, :] < _as_lengths(lengths, w.device)[:, None]
        w = torch.where(keep[..., None], w, torch.zeros_like(w))
    prod = (ea * w).reshape(-1, K).T @ eq.reshape(-1, K)
    return torch.where(p > 0, p * prod, torch.zeros_like(prod))
