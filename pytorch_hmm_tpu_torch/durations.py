"""Duration distributions for explicit-duration (semi-Markov) models.

Port of ``pytorch_hmm_tpu/durations.py``: log-pmf functions over the
integer duration grid ``d ∈ [1, max_duration]``, continuous pdfs
evaluated at integer durations and truncated below ``min_duration``.
Each returns ``(..., D)`` with ``D = max_duration``, column ``j`` holding
duration ``j+1``; entries below ``min_duration`` are ``-inf``. The
truncated scores are left unnormalized unless ``normalize=True``.
"""

from __future__ import annotations

import math

import torch

from .core.semiring import logsumexp

__all__ = [
    "duration_grid",
    "gamma_duration_log_pmf",
    "poisson_duration_log_pmf",
    "weibull_duration_log_pmf",
    "gaussian_duration_log_pmf",
    "finalize_duration_log_pmf",
]

_EPS = 1e-8


def duration_grid(max_duration: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Durations ``[1, 2, ..., max_duration]`` as a float vector."""
    return torch.arange(1, max_duration + 1, dtype=dtype, device=device)


def finalize_duration_log_pmf(
    log_p: torch.Tensor, min_duration: int = 1, normalize: bool = False
) -> torch.Tensor:
    """Apply the min-duration truncation (and optional normalization)."""
    d = torch.arange(1, log_p.shape[-1] + 1, device=log_p.device)
    log_p = torch.where(d >= min_duration, log_p, float("-inf"))
    if normalize:
        log_p = log_p - logsumexp(log_p, dim=-1, keepdim=True)
    return log_p


def _grid(param: torch.Tensor, max_duration: int) -> torch.Tensor:
    return duration_grid(max_duration, param.dtype, param.device)[None, :]


def gamma_duration_log_pmf(shape, rate, max_duration: int, min_duration: int = 1,
                           normalize: bool = False) -> torch.Tensor:
    """Gamma(shape, rate) log-density at integer durations; ``shape`` and
    ``rate`` are ``(S,)``."""
    d = _grid(shape, max_duration)
    sh, ra = shape[:, None], rate[:, None]
    log_p = (sh - 1.0) * torch.log(d + _EPS) - ra * d - torch.lgamma(sh) + sh * torch.log(ra + _EPS)
    return finalize_duration_log_pmf(log_p, min_duration, normalize)


def poisson_duration_log_pmf(lam, max_duration: int, min_duration: int = 1,
                             normalize: bool = False) -> torch.Tensor:
    """Poisson(λ) log-pmf at integer durations."""
    d = _grid(lam, max_duration)
    la = lam[:, None]
    log_p = d * torch.log(la + _EPS) - la - torch.lgamma(d + 1.0)
    return finalize_duration_log_pmf(log_p, min_duration, normalize)


def weibull_duration_log_pmf(scale, concentration, max_duration: int, min_duration: int = 1,
                             normalize: bool = False) -> torch.Tensor:
    """Weibull(scale, concentration) log-density at integer durations."""
    d = _grid(scale, max_duration)
    sc, co = scale[:, None], concentration[:, None]
    log_p = (
        torch.log(co + _EPS)
        - co * torch.log(sc + _EPS)
        + (co - 1.0) * torch.log(d + _EPS)
        - (d / sc) ** co
    )
    return finalize_duration_log_pmf(log_p, min_duration, normalize)


def gaussian_duration_log_pmf(mean, std, max_duration: int, min_duration: int = 1,
                              normalize: bool = False) -> torch.Tensor:
    """Discretized Gaussian over durations."""
    d = _grid(mean, max_duration)
    mu, sd = mean[:, None], std[:, None]
    log_p = (
        -0.5 * ((d - mu) / (sd + _EPS)) ** 2
        - torch.log(sd + _EPS)
        - 0.5 * math.log(2.0 * math.pi)
    )
    return finalize_duration_log_pmf(log_p, min_duration, normalize)
