"""MixtureGaussianHMMLayer — GMM-HMM acoustic model, decode path.

Port of ``pytorch_hmm_tpu/models/mixture_gaussian.py`` as an
``nn.Module``: S states, C mixture components per state, diag / tied /
spherical covariances, learnable or fixed left-to-right transitions,
batched Viterbi decode (``forward``) and the frozen serving decoder
(``make_decoder``). Decoding on CUDA tensors goes through the two hand
kernels (``ops.emit.diag_quadratic`` and ``ops.smallk.smallk_viterbi``).

Full covariance, ``log_likelihood``, ``compute_loss`` and ``em_step``
come with later slices (ROADMAP queue 1 items 2 to 4).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.semiring import logsumexp, safe_log
from ..emissions import _FULL_COV_TODO, gmm_component_log_probs, gmm_log_probs
from ..ops import auto_gmm_viterbi, auto_viterbi

__all__ = ["MixtureGaussianHMMLayer", "PreparedGMMDecoder"]


class PreparedGMMDecoder:
    """Parameter-frozen GMM-HMM Viterbi decoder (see ``make_decoder``).

    Holds detached copies of the emission tables and the log
    transitions; ``__call__`` scores the observations and runs the
    trellis, with the same results as ``MixtureGaussianHMMLayer.forward``.
    """

    def __init__(self, emission_tables: dict, log_a: torch.Tensor,
                 log_pi: torch.Tensor, num_states: int, num_components: int,
                 covariance_type: str):
        self.emission_tables = emission_tables
        self.log_a = log_a
        self.log_pi = log_pi
        self.num_states = num_states
        self.num_components = num_components
        self.covariance_type = covariance_type

    def log_obs(self, observations: torch.Tensor) -> torch.Tensor:
        """State emission scores ``(B, T, S)`` from the frozen tables."""
        t = self.emission_tables
        return gmm_log_probs(
            observations, t["means"], t["cov_params"], t["log_w"],
            self.covariance_type,
        )

    @torch.no_grad()
    def __call__(
        self,
        observations: torch.Tensor,
        return_log_probs: bool = False,
        lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        states, score = auto_viterbi(
            self.log_obs(observations), self.log_a, self.log_pi, lengths
        )
        return (states, score) if return_log_probs else (states, None)


def _l2r_fixed(num_states: int) -> torch.Tensor:
    """Fixed decode topology: 0.8 self-loop / 0.2 forward, last state
    absorbing."""
    p = 0.8 * torch.eye(num_states) + 0.2 * torch.diag(torch.ones(num_states - 1), 1)
    p[-1, -1] = 1.0
    return p


class MixtureGaussianHMMLayer(nn.Module):
    """GMM-HMM with diag / tied / spherical covariances (decode path).

    Parameters are initialised from ``generator`` (a ``torch.Generator``;
    a fresh one seeded with 0 when omitted). Torch cannot reproduce the
    JAX package's ``nnx.Rngs`` draws, so weights are carried across with
    ``bridge.mixture_gaussian_state_dict`` where the two must agree.
    """

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        num_components: int = 3,
        covariance_type: str = "diag",
        learnable_transitions: bool = True,
        max_sequence_length: int = 10000,
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        if covariance_type == "full":
            raise NotImplementedError(_FULL_COV_TODO)
        if covariance_type not in ("diag", "tied", "spherical"):
            raise ValueError(f"Unknown covariance_type: {covariance_type}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.num_components = num_components
        self.covariance_type = covariance_type
        self.learnable_transitions = learnable_transitions
        self.max_sequence_length = max_sequence_length

        S, C, D = num_states, num_components, feature_dim

        def randn(*shape):
            return torch.randn(shape, generator=generator).to(device)

        if learnable_transitions:
            self.transition_logits = nn.Parameter(randn(S, S) * 0.1)
        else:
            self.register_buffer("transition_matrix", _l2r_fixed(S).to(device))
        self.mixture_weights_logits = nn.Parameter(randn(S, C) * 0.1)
        self.means = nn.Parameter(randn(S, C, D) * math.sqrt(2.0 / D))
        cov_shape = {"diag": (S, C, D), "tied": (D,), "spherical": (S, C)}
        self.cov_params = nn.Parameter(
            torch.zeros(cov_shape[covariance_type], device=device)
        )

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> torch.Tensor:
        if self.learnable_transitions:
            return torch.softmax(self.transition_logits, dim=-1)
        return self.transition_matrix

    def _log_a(self) -> torch.Tensor:
        if self.learnable_transitions:
            return torch.log_softmax(self.transition_logits, dim=-1)
        return safe_log(self.transition_matrix)

    def _log_pi(self) -> torch.Tensor:
        # Uniform decode prior, as in the JAX package.
        return torch.full(
            (self.num_states,), -math.log(self.num_states),
            device=self.means.device,
        )

    # -- emissions --------------------------------------------------------------
    def get_component_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        """Per-component scores ``(B, T, S, C)`` (before mixture weights)."""
        return gmm_component_log_probs(
            observations, self.means, self.cov_params, self.covariance_type
        )

    def get_observation_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        """State scores ``(B, T, S)``. On CUDA the emission kernel has no
        backward yet, so call this under ``torch.no_grad()`` there."""
        comp = self.get_component_log_probs(observations)
        log_w = torch.log_softmax(self.mixture_weights_logits, dim=-1)
        return logsumexp(comp + log_w, dim=-1)

    # -- inference ---------------------------------------------------------------
    @torch.no_grad()
    def forward(
        self,
        observations: torch.Tensor,
        return_log_probs: bool = False,
        lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Viterbi decode: ``(states (B, T) int32, score (B,) | None)``.
        ``lengths`` masks ragged batches (padded frames repeat each row's
        final valid state)."""
        log_w = torch.log_softmax(self.mixture_weights_logits, dim=-1)
        states, score = auto_gmm_viterbi(
            observations, self.means, self.cov_params, log_w,
            self._log_a(), self._log_pi(), lengths,
            covariance_type=self.covariance_type,
        )
        return (states, score) if return_log_probs else (states, None)

    @torch.no_grad()
    def make_decoder(self) -> PreparedGMMDecoder:
        """Freeze the current parameters into a serving decoder.

        Parameters are captured by value: after further training, call
        ``make_decoder()`` again for a fresh snapshot.
        """
        tables = {
            "means": self.means.detach().clone(),
            "cov_params": self.cov_params.detach().clone(),
            "log_w": torch.log_softmax(self.mixture_weights_logits, dim=-1),
        }
        return PreparedGMMDecoder(
            tables, self._log_a(), self._log_pi(), self.num_states,
            self.num_components, self.covariance_type,
        )

    def get_model_info(self) -> dict:
        """Configuration and parameter statistics."""
        total = sum(p.numel() for p in self.parameters())
        return {
            "num_states": self.num_states,
            "feature_dim": self.feature_dim,
            "num_components": self.num_components,
            "covariance_type": self.covariance_type,
            "learnable_transitions": self.learnable_transitions,
            "total_parameters": int(total),
            "trainable_parameters": int(total),
            "memory_efficient": True,
            "max_sequence_length": self.max_sequence_length,
        }
