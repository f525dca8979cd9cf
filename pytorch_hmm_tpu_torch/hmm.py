"""User-facing HMM class with fixed parameters.

Port of ``pytorch_hmm_tpu/hmm.py``. One class holds the row-normalized
transition matrix ``P`` and initial distribution ``p0`` on a device (the
CUDA device unless ``device`` names another) and runs inference on
per-state observation **probabilities** (log taken with a 1e-8
epsilon), shaped ``(T, K)`` or ``(B, T, K)``; unbatched inputs get
unbatched outputs.

On CUDA the default ``method="scan"`` of ``forward_backward``,
``viterbi_decode`` and ``compute_likelihood`` goes through the
dispatch (``ops.auto_forward_backward``, ``auto_viterbi``,
``auto_log_likelihood``): the hand kernels for K ≤ 1024 (the small-K
kernels to 32 states, ``ops.scan`` above). The JAX package's
``viterbi_decode`` and ``compute_likelihood`` call its plain XLA scans;
the kernels give the same paths and values. ``method="associative"``
and ``"blocked"`` run the plain parallel-in-time ``core`` versions on
any device.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import core, ops
from .core.semiring import safe_log

__all__ = ["HMM", "HMMJax", "HMMPyTorch"]

ArrayLike = Union[np.ndarray, torch.Tensor, list]


class HMM:
    """Hidden Markov model with fixed parameters.

    Args:
        P: ``(K, K)`` transition matrix (row-stochastic; renormalized here).
        p0: ``(K,)`` initial state probabilities (uniform if ``None``).
        device: where the parameters live and inference runs; the CUDA
            device unless named.
    """

    def __init__(self, P: ArrayLike, p0: Optional[ArrayLike] = None,
                 dtype=torch.float32, device="cuda"):
        P = torch.as_tensor(P, dtype=dtype, device=device)
        if P.ndim != 2 or P.shape[0] != P.shape[1]:
            raise ValueError(f"P must be a square matrix, got {tuple(P.shape)}")
        self.P = P / torch.sum(P, dim=-1, keepdim=True)
        if p0 is None:
            k = P.shape[0]
            self.p0 = torch.full((k,), 1.0 / k, dtype=dtype, device=device)
        else:
            p0 = torch.as_tensor(p0, dtype=dtype, device=device)
            self.p0 = p0 / torch.sum(p0)

    @property
    def device(self) -> torch.device:
        return self.P.device

    @property
    def num_states(self) -> int:
        return self.P.shape[-1]

    @property
    def log_P(self) -> torch.Tensor:
        return safe_log(self.P)

    @property
    def log_p0(self) -> torch.Tensor:
        return safe_log(self.p0)

    def _batched(self, observations: ArrayLike) -> tuple[torch.Tensor, bool]:
        obs = torch.as_tensor(observations, dtype=self.P.dtype, device=self.device)
        if obs.ndim == 2:
            return obs[None], False
        if obs.ndim == 3:
            return obs, True
        raise ValueError(f"observations must be (T,K) or (B,T,K), got {tuple(obs.shape)}")

    def _lengths(self, lengths):
        return None if lengths is None else torch.as_tensor(lengths, device=self.device)

    def forward_backward(self, observations: ArrayLike, method: str = "scan",
                         lengths: Optional[ArrayLike] = None):
        """Posteriors from per-state observation probabilities:
        ``(posterior, alpha, beta)`` in probability space with the
        input's batchedness (alpha and beta are the exponentiated log
        tables). ``lengths (B,)`` marks ragged batches: padded frames get
        zero posteriors, and results match per-sequence unpadded calls."""
        obs, batched = self._batched(observations)
        log_obs = safe_log(obs)
        lengths = self._lengths(lengths)
        if method == "scan":
            log_gamma, log_alpha, log_beta, _ = ops.auto_forward_backward(
                log_obs, self.log_P, self.log_p0, lengths)
        else:
            log_gamma, log_alpha, log_beta, _ = core.forward_backward(
                log_obs, self.log_P, self.log_p0, lengths, method=method)
        out = (torch.exp(log_gamma), torch.exp(log_alpha), torch.exp(log_beta))
        if lengths is not None:
            valid = (torch.arange(obs.shape[1], device=self.device)[None, :]
                     < lengths[:, None])[..., None]
            out = tuple(torch.where(valid, o, torch.zeros_like(o)) for o in out)
        if not batched:
            out = tuple(o[0] for o in out)
        return out

    def viterbi_decode(self, observations: ArrayLike, method: str = "scan",
                       lengths: Optional[ArrayLike] = None):
        """Best path ``(states int32, log score)``. ``method``: ``scan``
        (sequential; the trellis kernels on CUDA), ``associative``
        (O(log T) depth) or ``blocked`` (time blocks side by side), all
        exact. ``lengths (B,)`` marks ragged batches (padded frames
        repeat each row's final valid state)."""
        obs, batched = self._batched(observations)
        log_obs = safe_log(obs)
        lengths = self._lengths(lengths)
        if method == "associative":
            states, score = core.viterbi_associative(log_obs, self.log_P, self.log_p0, lengths)
        elif method == "blocked":
            states, score = core.viterbi_blocked(log_obs, self.log_P, self.log_p0,
                                                 lengths=lengths)
        else:
            states, score = ops.auto_viterbi(log_obs, self.log_P, self.log_p0, lengths)
        if not batched:
            return states[0], score[0]
        return states, score

    def compute_likelihood(self, observations: ArrayLike, method: str = "scan",
                           lengths: Optional[ArrayLike] = None) -> torch.Tensor:
        """Sequence log-likelihood ``(B,)`` (a scalar if unbatched)."""
        obs, batched = self._batched(observations)
        log_obs = safe_log(obs)
        lengths = self._lengths(lengths)
        if method == "scan":
            ll = ops.auto_log_likelihood(log_obs, self.log_P, self.log_p0, lengths)
        else:
            ll = core.log_likelihood(log_obs, self.log_P, self.log_p0, lengths, method=method)
        return ll if batched else ll[0]

    def sample(self, seq_length: int, batch_size: int = 1,
               generator: Optional[torch.Generator] = None):
        """One-hot observations and state paths ``((B, T, K), (B, T))``,
        drawn with ``generator`` (on the model's device; one seeded with 0
        when omitted)."""
        return core.sample_one_hot(generator, self.log_P, self.log_p0, seq_length, batch_size)


# The JAX package exposes the same class under both of these names.
HMMJax = HMM
HMMPyTorch = HMM
