"""Emission (observation) models as log-prob functions on tensors.

Port of ``pytorch_hmm_tpu/emissions.py``: diag, tied, spherical and full
covariance. Each function maps ``(B, T, D)`` observations to ``(B, T,
K)`` log-probs. The diagonal quadratic form is expanded so scoring is
two ``(B·T, D) × (D, K)`` products::

    (x-μ)ᵀ diag(1/σ²) (x-μ) = x²·(1/σ²) − 2x·(μ/σ²) + Σ μ²/σ²

which ``ops.emit.diag_quadratic`` evaluates with one read of the
observations (the hand kernel on CUDA, plain torch on CPU). Its
autograd Function carries gradients back to the means and
log-variances on both devices, so the diag and tied scores train as
they decode. ``gaussian_log_probs`` is ``GaussianHMMLayer``'s entry,
parameterized by log standard deviations.

Full covariance goes through precision matrices from the inverse
Cholesky factors (:func:`fullcov_prepare`) and the expansion
``xᵀPx − 2x·(Pμ̃) + μ̃ᵀPμ̃`` on coordinates centered on the mean of the
means, as plain ``torch.matmul`` products (XLA products in the JAX
package, which has no kernel for them either), chunked over time only
to bound memory. Float32 products must run in full float32: the
emission scores feed posterior-grade chains, so TF32
(``torch.backends.cuda.matmul.allow_tf32``, off by default) stays off.

Every scoring function takes ``compute_dtype``, as in the JAX package.
``None`` or ``torch.float32`` is the path above: true float32, the diag
quadratic through the kernel on the card. ``torch.bfloat16`` rounds the
contractions' operands to bf16 and accumulates in float32
(:func:`precision.mxu_einsum`), in plain torch on every device: the
JAX package's own path off the TPU. The returned scores are float32
either way.
"""

from __future__ import annotations

import math

import torch

from .core.semiring import logsumexp
from .ops.emit import diag_quadratic
from .precision import compute_dtype as _resolve_dtype
from .precision import mxu_einsum

__all__ = [
    "diag_gaussian_log_probs",
    "flat_dim",
    "full_gaussian_log_probs",
    "full_gaussian_log_probs_prepared",
    "fullcov_mixture_log_probs_prepared",
    "fullcov_prepare",
    "gaussian_log_probs",
    "gmm_component_log_probs",
    "gmm_log_probs",
    "spherical_gaussian_log_probs",
    "tril_from_flat",
    "tril_inverse",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _bf16(compute_dtype) -> bool:
    """True when ``compute_dtype`` asks for bf16 contractions."""
    return _resolve_dtype(compute_dtype) == torch.bfloat16


def diag_gaussian_log_probs(
    obs: torch.Tensor, means: torch.Tensor, log_vars: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """Diagonal-covariance Gaussian scores.

    Args:
        obs: ``(B, T, D)``; means: ``(K, D)``; log_vars: ``(K, D)``.
        compute_dtype: the contraction dtype (module docstring).
    Returns:
        ``(B, T, K)`` log N(obs; mean_k, diag(exp(log_vars_k))).
    """
    D = obs.shape[-1]
    inv_var = torch.exp(-log_vars)                        # (K, D)
    mm = torch.sum(means * means * inv_var, dim=-1)       # (K,)
    log_norm = -0.5 * (D * _LOG_2PI + torch.sum(log_vars, dim=-1))
    if _bf16(compute_dtype):
        # The JAX package's form off the TPU: [x², x, 1] @ [1/σ²; -2μ/σ²;
        # Σμ²/σ²], x squared in float32 before the bf16 rounding.
        W = torch.cat([inv_var, -2.0 * means * inv_var, mm[..., None]], dim=-1)
        aug = torch.cat([obs * obs, obs, torch.ones_like(obs[..., :1])], dim=-1)
        return log_norm - 0.5 * mxu_einsum("bte,ke->btk", aug, W, dtype=torch.bfloat16)
    mahal = diag_quadratic(
        obs.contiguous(),
        inv_var.T.contiguous(),
        (-2.0 * means * inv_var).T.contiguous(),
        mm.contiguous(),
    )
    return log_norm - 0.5 * mahal


def spherical_gaussian_log_probs(
    obs: torch.Tensor, means: torch.Tensor, log_vars: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """Isotropic Gaussian scores; ``log_vars`` is ``(K,)`` (σ² shared over
    dimensions). A plain product on every device, as in the JAX package."""
    D = obs.shape[-1]
    inv_var = torch.exp(-log_vars)                        # (K,)
    x2 = torch.sum(obs * obs, dim=-1)                     # (B, T)
    if _bf16(compute_dtype):
        xm = mxu_einsum("btd,kd->btk", obs, means, dtype=torch.bfloat16)
    else:
        xm = obs @ means.T                                # (B, T, K)
    m2 = torch.sum(means * means, dim=-1)                 # (K,)
    mahal = (x2[..., None] - 2.0 * xm + m2) * inv_var
    log_norm = -0.5 * D * (_LOG_2PI + log_vars)
    return log_norm - 0.5 * mahal


def fullcov_prepare(means: torch.Tensor, chol: torch.Tensor) -> dict:
    """Observation-independent tables for full-covariance scoring, from
    means ``(K, D)`` and lower-triangular Cholesky factors ``chol (K, D,
    D)`` with positive diagonals.

    Returns ``{"prec": (K, D, D) Σ⁻¹, "pm": (K, D) Σ⁻¹μ̃, "mm": (K,)
    μ̃ᵀΣ⁻¹μ̃, "center": (D,), "log_norm": (K,)}``, with μ̃ the means
    centered on their mean ``center``: shifting x and μ by the same
    constant is exact, and keeps the expansion O(Mahalanobis distance)
    for features far from the origin.
    """
    D = means.shape[-1]
    inv_chol = tril_inverse(chol)                                   # L⁻¹
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    log_norm = -0.5 * D * _LOG_2PI - logdet
    center = torch.mean(means, dim=0)
    mu_c = means - center
    wm = torch.einsum("ked,kd->ke", inv_chol, mu_c)                # L⁻¹ μ̃
    prec = torch.einsum("ked,kef->kdf", inv_chol, inv_chol)        # Σ⁻¹
    pm = torch.einsum("kde,ke->kd", prec, mu_c)
    mm = torch.sum(wm * wm, dim=-1)
    return {"prec": prec, "pm": pm, "mm": mm, "center": center, "log_norm": log_norm}


def _fullcov_scored_prepared(obs, prep, time_chunk, compute_dtype, mixture):
    D = obs.shape[-1]
    prec, pm, mm = prep["prec"], prep["pm"], prep["mm"]
    K = prec.shape[0]
    # bf16 contractions: the operands (centered x, Σ⁻¹, Σ⁻¹μ̃) rounded to
    # bf16, every product and sum in float32, as the JAX package's
    # mxu_einsum computes them off the TPU.
    rnd = (lambda t: t.to(torch.bfloat16).to(torch.float32)) if _bf16(compute_dtype) else (lambda t: t)
    prec, pm = rnd(prec), rnd(pm)
    # prec as one (D, K·D) operand: x @ W gives every component's Px.
    W = prec.permute(1, 0, 2).reshape(D, K * D)

    def score(x):
        x = rnd(x - prep["center"])
        px = (x @ W).reshape(*x.shape[:-1], K, D)
        xpx = torch.einsum("btkd,btd->btk", px, x)
        # A true Mahalanobis distance is non-negative; clamp so rounding
        # in the expansion never lifts a score above log_norm.
        mahal = torch.clamp(xpx - 2.0 * (x @ pm.T) + mm, min=0.0)
        out = prep["log_norm"] - 0.5 * mahal
        if mixture is not None:
            out = logsumexp(out.reshape(*out.shape[:-1], *mixture), dim=-1)
        return out

    T = obs.shape[1]
    if T <= time_chunk:
        return score(obs)
    # Time chunks bound the (B, τ, K·D) intermediate (0.49 GB unchunked
    # at B=32, T=1000, K=48, D=80).
    return torch.cat([score(obs[:, t:t + time_chunk]) for t in range(0, T, time_chunk)], dim=1)


def full_gaussian_log_probs_prepared(
    obs: torch.Tensor, prep: dict, time_chunk: int = 128, compute_dtype=None
) -> torch.Tensor:
    """Full-covariance scores ``(B, T, K)`` from :func:`fullcov_prepare`
    tables, ``time_chunk`` frames at a time."""
    return _fullcov_scored_prepared(obs, prep, time_chunk, compute_dtype, mixture=None)


def fullcov_mixture_log_probs_prepared(
    obs: torch.Tensor,
    prep: dict,
    num_states: int,
    num_components: int,
    time_chunk: int = 128,
    compute_dtype=None,
) -> torch.Tensor:
    """Mixture-marginalized state scores ``(B, T, S)`` from
    :func:`fullcov_prepare` tables with the log mixture weights folded
    into ``prep["log_norm"]``; the logsumexp over components runs inside
    each time chunk, so no ``(B, T, S·C)`` tensor is formed (the serving
    decoder, ``MixtureGaussianHMMLayer.make_decoder``)."""
    return _fullcov_scored_prepared(obs, prep, time_chunk, compute_dtype,
                                    mixture=(num_states, num_components))


def full_gaussian_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    chol: torch.Tensor,
    time_chunk: int = 128,
    compute_dtype=None,
) -> torch.Tensor:
    """Full-covariance Gaussian scores ``(B, T, K)`` from means ``(K, D)``
    and lower-triangular Cholesky factors ``chol (K, D, D)`` with
    positive diagonals: :func:`fullcov_prepare`, then
    :func:`full_gaussian_log_probs_prepared`."""
    return full_gaussian_log_probs_prepared(obs, fullcov_prepare(means, chol), time_chunk, compute_dtype)


def gaussian_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    log_scales: torch.Tensor,
    covariance_type: str = "diag",
    compute_dtype=None,
) -> torch.Tensor:
    """``GaussianHMMLayer``'s scores ``(B, T, K)``: ``log_scales`` are
    log standard deviations, ``(K, D)`` for diag and ``(K, 1)`` for
    spherical, so ``log_var = 2 · log_scales``. For full covariance
    ``log_scales (K, D, D)`` are raw: the Cholesky factor is their strict
    lower triangle plus ``exp`` of their diagonal."""
    if covariance_type == "diag":
        return diag_gaussian_log_probs(obs, means, 2.0 * log_scales, compute_dtype)
    if covariance_type == "spherical":
        return spherical_gaussian_log_probs(obs, means, 2.0 * log_scales[..., 0], compute_dtype)
    if covariance_type == "full":
        diag = torch.exp(torch.diagonal(log_scales, dim1=-2, dim2=-1))
        chol = torch.tril(log_scales, diagonal=-1) + torch.diag_embed(diag)
        return full_gaussian_log_probs(obs, means, chol, compute_dtype=compute_dtype)
    raise ValueError(f"Unknown covariance_type: {covariance_type}")


# -- GMM emissions ----------------------------------------------------------------


def flat_dim(d: int) -> int:
    """Size of the flattened lower triangle of a ``(d, d)`` matrix."""
    return d * (d + 1) // 2


def tril_from_flat(flat: torch.Tensor, d: int) -> torch.Tensor:
    """Unpack ``(..., d(d+1)/2)``, the lower triangle in row-major order,
    into lower-triangular ``(..., d, d)`` with diagonal ``softplus +
    1e-4``, so the covariance is always positive definite. A gather from
    the flat vector with a zero appended, as the JAX package builds it."""
    n = flat.shape[-1]
    rows, cols = torch.tril_indices(d, d)
    index = torch.full((d, d), n, dtype=torch.long)
    index[rows, cols] = torch.arange(rows.numel())
    padded = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], 1)], dim=-1)
    L = padded[..., index.reshape(-1).to(flat.device)].reshape(*flat.shape[:-1], d, d)
    diag = torch.nn.functional.softplus(torch.diagonal(L, dim1=-2, dim2=-1)) + 1e-4
    return torch.tril(L, diagonal=-1) + torch.diag_embed(diag)


def tril_inverse(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of lower-triangular ``L (..., d, d)``, lower
    triangular. A triangular solve against the identity; the JAX package
    runs a Newton iteration instead only because the TPU's triangular
    solve was slow."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.tril(torch.linalg.solve_triangular(L, eye, upper=False))


def gmm_component_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    covariance_type: str = "diag",
    time_chunk: int = 128,
    compute_dtype=None,
) -> torch.Tensor:
    """Per-component Gaussian scores ``(B, T, S, C)``.

    means: ``(S, C, D)``. cov_params by type: ``diag`` → log-variances
    ``(S, C, D)``; ``full`` → flattened Cholesky factors ``(S, C,
    D(D+1)/2)`` (:func:`tril_from_flat`); ``tied`` → shared
    log-variances ``(D,)``; ``spherical`` → log-variance ``(S, C)``.
    ``time_chunk`` bounds the full-covariance scorer's intermediate.
    """
    B, T, D = obs.shape
    S, C, _ = means.shape
    m2 = means.reshape(S * C, D)

    if covariance_type == "diag":
        out = diag_gaussian_log_probs(obs, m2, cov_params.reshape(S * C, D), compute_dtype)
    elif covariance_type == "tied":
        # One diagonal covariance shared across all states/components.
        lv2 = cov_params.expand(S * C, D)
        out = diag_gaussian_log_probs(obs, m2, lv2, compute_dtype)
    elif covariance_type == "spherical":
        out = spherical_gaussian_log_probs(obs, m2, cov_params.reshape(S * C), compute_dtype)
    elif covariance_type == "full":
        chol = tril_from_flat(cov_params.reshape(S * C, -1), D)
        out = full_gaussian_log_probs(obs, m2, chol, time_chunk, compute_dtype)
    else:
        raise ValueError(f"Unknown covariance_type: {covariance_type}")
    return out.reshape(B, T, S, C)


def gmm_log_probs(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    mixture_logits: torch.Tensor,
    covariance_type: str = "diag",
    time_chunk: int = 128,
    compute_dtype=None,
) -> torch.Tensor:
    """Mixture-marginalized state scores ``(B, T, S)``:
    ``logsumexp_c(log w_{s,c} + log N_c(x))``."""
    comp = gmm_component_log_probs(obs, means, cov_params, covariance_type, time_chunk, compute_dtype)
    log_w = torch.log_softmax(mixture_logits, dim=-1)     # (S, C)
    return logsumexp(comp + log_w, dim=-1)
