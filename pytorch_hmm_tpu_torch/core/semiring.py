"""Semiring primitives for HMM dynamic programming, on torch tensors.

Port of ``pytorch_hmm_tpu/core/semiring.py``: the same log-space
conventions (row-stochastic ``A[i, j] = P(s_t = j | s_{t-1} = i)``,
``-inf`` for impossible transitions, every op ``-inf``-safe).

* sum-product (log semiring, ``(logsumexp, +)``): :func:`log_matvec`,
  :func:`log_matvec_t`, :func:`log_matmul` — the forward and backward
  recursions and the associative-scan combine;
* max-product (tropical semiring, ``(max, +)``): :func:`max_matvec`,
  :func:`max_matmul` — Viterbi.
"""

from __future__ import annotations

import torch

__all__ = [
    "LOG_ZERO",
    "logsumexp",
    "log_matvec",
    "log_matvec_t",
    "log_matmul",
    "max_matvec",
    "max_matmul",
    "normalize_log",
    "safe_log",
]

# A finite stand-in for log(0) where -inf would create NaNs under
# autodiff (same value as the JAX package).
LOG_ZERO = -1e30


def logsumexp(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``-inf``-safe logsumexp: a row of all ``-inf`` gives ``-inf``.

    Max-shifted with a detached max, as the JAX package's: the gradient
    is ``exp(x - m) / sum(exp(x - m))``, whose weights sum to 1 however
    large ``|x|``. ``torch.logsumexp``'s backward weights ``exp(x - out)``
    carry ``out``'s rounding, which at |log Z| ~ 1e4 (long f32 chains)
    puts ~1e-3 into every gradient. A non-finite max (a row of ``-inf``)
    shifts by 0; an empty ``dim`` gives ``-inf``.
    """
    if x.shape[dim] == 0:
        return torch.logsumexp(x, dim=dim, keepdim=keepdim)
    m = x.amax(dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))
    return out if keepdim else out.squeeze(dim)


def log_matvec(v: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """``out[..., j] = logsumexp_i(v[..., i] + log_a[..., i, j])`` — one
    forward step (``v`` is ``log alpha_{t-1}``)."""
    return logsumexp(v[..., :, None] + log_a, dim=-2)


def log_matvec_t(log_a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = logsumexp_j(log_a[..., i, j] + v[..., j])`` — one
    backward step."""
    return logsumexp(log_a + v[..., None, :], dim=-1)


def log_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = logsumexp_k(x[..., i, k] + y[..., k, j])`` — the
    associative combine of the parallel-in-time forward and backward."""
    return logsumexp(x[..., :, :, None] + y[..., None, :, :], dim=-2)


def max_matvec(v: torch.Tensor, log_a: torch.Tensor):
    """Max-product vector-matrix product with argmax.

    ``out[..., j] = max_i(v[..., i] + log_a[i, j])``; returns
    ``(values, indices)``. Ties go to the lowest ``i``, as
    ``jnp.argmax`` does.
    """
    return (v[..., :, None] + log_a).max(dim=-2)


def max_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Max-product matrix-matrix product (no argmax)."""
    return (x[..., :, :, None] + y[..., None, :, :]).amax(dim=-2)


def safe_log(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Elementwise ``log(x + eps)`` for probability-space inputs."""
    return torch.log(x + eps)


def normalize_log(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize a log-space distribution so that exp sums to 1 over ``dim``."""
    return x - logsumexp(x, dim=dim, keepdim=True)
