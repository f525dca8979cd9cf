"""Semiring primitives for HMM dynamic programming, on torch tensors.

Port of ``pytorch_hmm_tpu/core/semiring.py``: the same log-space
conventions (row-stochastic ``A[i, j] = P(s_t = j | s_{t-1} = i)``,
``-inf`` for impossible transitions, every op ``-inf``-safe). Only the
pieces the decode path needs are here; the sum-product matrix products
come with the forward/backward slice.
"""

from __future__ import annotations

import torch

__all__ = ["LOG_ZERO", "logsumexp", "max_matvec", "safe_log"]

# A finite stand-in for log(0) where -inf would create NaNs under
# autodiff (same value as the JAX package).
LOG_ZERO = -1e30


def logsumexp(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``-inf``-safe logsumexp: a row of all ``-inf`` gives ``-inf``."""
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)


def max_matvec(v: torch.Tensor, log_a: torch.Tensor):
    """Max-product vector-matrix product with argmax.

    ``out[..., j] = max_i(v[..., i] + log_a[i, j])``; returns
    ``(values, indices)``. Ties go to the lowest ``i``, as
    ``jnp.argmax`` does.
    """
    return (v[..., :, None] + log_a).max(dim=-2)


def safe_log(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Elementwise ``log(x + eps)`` for probability-space inputs."""
    return torch.log(x + eps)
