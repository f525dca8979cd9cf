"""Emission (observation) models as log-prob functions on tensors.

Port of the diag, tied and spherical families of
``pytorch_hmm_tpu/emissions.py``. Each function maps ``(B, T, D)``
observations to ``(B, T, K)`` float32 log-probs. The diagonal quadratic
form is expanded so scoring is two ``(B·T, D) × (D, K)`` products::

    (x-μ)ᵀ diag(1/σ²) (x-μ) = x²·(1/σ²) − 2x·(μ/σ²) + Σ μ²/σ²

which ``ops.emit.diag_quadratic`` evaluates with one read of the
observations (the hand kernel on CUDA, plain torch on CPU). Its
autograd Function carries gradients back to the means and
log-variances on both devices, so the diag and tied scores train as
they decode. ``gaussian_log_probs`` is ``GaussianHMMLayer``'s entry,
parameterized by log standard deviations. Full covariance is not ported
yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from .core.semiring import logsumexp
from .ops.emit import diag_quadratic

__all__ = [
    "diag_gaussian_log_probs",
    "gaussian_log_probs",
    "spherical_gaussian_log_probs",
    "gmm_component_log_probs",
    "gmm_log_probs",
]

_LOG_2PI = math.log(2.0 * math.pi)

_FULL_COV_TODO = (
    "full covariance is not ported yet: ROADMAP queue 1 item 2 "
    "(fullcov_prepare, tril_inverse, full_gaussian_log_probs_prepared)"
)


def diag_gaussian_log_probs(
    obs: torch.Tensor, means: torch.Tensor, log_vars: torch.Tensor
) -> torch.Tensor:
    """Diagonal-covariance Gaussian scores.

    Args:
        obs: ``(B, T, D)``; means: ``(K, D)``; log_vars: ``(K, D)``.
    Returns:
        ``(B, T, K)`` log N(obs; mean_k, diag(exp(log_vars_k))).
    """
    D = obs.shape[-1]
    inv_var = torch.exp(-log_vars)                        # (K, D)
    mm = torch.sum(means * means * inv_var, dim=-1)       # (K,)
    log_norm = -0.5 * (D * _LOG_2PI + torch.sum(log_vars, dim=-1))
    mahal = diag_quadratic(
        obs.contiguous(),
        inv_var.T.contiguous(),
        (-2.0 * means * inv_var).T.contiguous(),
        mm.contiguous(),
    )
    return log_norm - 0.5 * mahal


def spherical_gaussian_log_probs(
    obs: torch.Tensor, means: torch.Tensor, log_vars: torch.Tensor
) -> torch.Tensor:
    """Isotropic Gaussian scores; ``log_vars`` is ``(K,)`` (σ² shared over
    dimensions). A plain product on every device, as in the JAX package."""
    D = obs.shape[-1]
    inv_var = torch.exp(-log_vars)                        # (K,)
    x2 = torch.sum(obs * obs, dim=-1)                     # (B, T)
    xm = obs @ means.T                                    # (B, T, K)
    m2 = torch.sum(means * means, dim=-1)                 # (K,)
    mahal = (x2[..., None] - 2.0 * xm + m2) * inv_var
    log_norm = -0.5 * D * (_LOG_2PI + log_vars)
    return log_norm - 0.5 * mahal


def gaussian_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    log_scales: torch.Tensor,
    covariance_type: str = "diag",
) -> torch.Tensor:
    """``GaussianHMMLayer``'s scores ``(B, T, K)``: ``log_scales`` are
    log standard deviations, ``(K, D)`` for diag and ``(K, 1)`` for
    spherical, so ``log_var = 2 · log_scales``."""
    if covariance_type == "diag":
        return diag_gaussian_log_probs(obs, means, 2.0 * log_scales)
    if covariance_type == "spherical":
        return spherical_gaussian_log_probs(obs, means, 2.0 * log_scales[..., 0])
    if covariance_type == "full":
        raise NotImplementedError(_FULL_COV_TODO)
    raise ValueError(f"Unknown covariance_type: {covariance_type}")


def gmm_component_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    covariance_type: str = "diag",
) -> torch.Tensor:
    """Per-component Gaussian scores ``(B, T, S, C)``.

    means: ``(S, C, D)``. cov_params by type: ``diag`` → log-variances
    ``(S, C, D)``; ``tied`` → shared log-variances ``(D,)``;
    ``spherical`` → log-variance ``(S, C)``.
    """
    B, T, D = obs.shape
    S, C, _ = means.shape
    m2 = means.reshape(S * C, D)

    if covariance_type == "diag":
        out = diag_gaussian_log_probs(obs, m2, cov_params.reshape(S * C, D))
    elif covariance_type == "tied":
        # One diagonal covariance shared across all states/components.
        lv2 = cov_params.expand(S * C, D)
        out = diag_gaussian_log_probs(obs, m2, lv2)
    elif covariance_type == "spherical":
        out = spherical_gaussian_log_probs(obs, m2, cov_params.reshape(S * C))
    elif covariance_type == "full":
        raise NotImplementedError(_FULL_COV_TODO)
    else:
        raise ValueError(f"Unknown covariance_type: {covariance_type}")
    return out.reshape(B, T, S, C)


def gmm_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    mixture_logits: torch.Tensor,
    covariance_type: str = "diag",
) -> torch.Tensor:
    """Mixture-marginalized state scores ``(B, T, S)``:
    ``logsumexp_c(log w_{s,c} + log N_c(x))``."""
    comp = gmm_component_log_probs(obs, means, cov_params, covariance_type)
    log_w = torch.log_softmax(mixture_logits, dim=-1)     # (S, C)
    return logsumexp(comp + log_w, dim=-1)
