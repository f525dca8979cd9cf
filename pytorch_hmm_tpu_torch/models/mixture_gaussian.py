"""MixtureGaussianHMMLayer — GMM-HMM acoustic model, decode and training.

Port of ``pytorch_hmm_tpu/models/mixture_gaussian.py`` as an
``nn.Module``: S states, C mixture components per state, diag / full /
tied / spherical covariances, learnable or fixed left-to-right transitions,
batched Viterbi decode (``forward``), the frozen serving decoder
(``make_decoder``), the differentiable ``log_likelihood`` /
``compute_loss`` for gradient training, and a closed-form Baum-Welch
``em_step``.

On CUDA tensors decoding goes through ``ops.emit.diag_quadratic`` and
``ops.smallk.smallk_viterbi``; the likelihood through
``diag_quadratic`` (an autograd Function) and the forward and backward
sum kernels (``ops.hsmm_smallk``, or ``ops.fbsum`` when ragged); EM
through ``diag_quadratic`` and ``ops.fbsum.fbsum_smallk``. With more
than 32 states, diag decode inside the fused envelope runs
``ops.fused.fused_gmm_viterbi`` and other decodes
``ops.scan.pallas_viterbi``; the likelihood and EM run
``ops.scan.pallas_forward`` / ``pallas_backward``, EM's transition
statistic as the product ``core.xi_sum``. Long unragged sequences
(T ≥ 1024) take the prob-space ``ops.scan.pallas_fb_prob`` in EM at any
S ≤ 128 and in the likelihood above 32 states. Full covariance scores
through ``emissions.full_gaussian_log_probs`` (plain products) into the
same kernels.

Distributed EM (``em_step(mesh=...)``) comes with ROADMAP queue 1 item
12.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .. import core
from ..core.semiring import logsumexp, safe_log
from ..emissions import (flat_dim, fullcov_mixture_log_probs_prepared, fullcov_prepare,
                         gmm_component_log_probs, gmm_log_probs, tril_from_flat)
from ..ops import (MAX_SMALLK, auto_forward_backward, auto_gmm_viterbi, auto_log_likelihood,
                   auto_viterbi)
from ..precision import maybe_remat

__all__ = ["MixtureGaussianHMMLayer", "PreparedGMMDecoder"]


class PreparedGMMDecoder:
    """Parameter-frozen GMM-HMM Viterbi decoder (see ``make_decoder``).

    Holds detached emission tables and the log transitions; ``__call__``
    scores the observations and runs the trellis, with the same results
    as ``MixtureGaussianHMMLayer.forward``. The tables are the means,
    covariance parameters and log weights or, for full covariance, the
    ``emissions.fullcov_prepare`` tables with the log mixture weights
    folded into ``log_norm``.
    """

    def __init__(self, emission_tables: dict, log_a: torch.Tensor, log_pi: torch.Tensor,
                 num_states: int, num_components: int, covariance_type: str):
        self.emission_tables = emission_tables
        self.log_a = log_a
        self.log_pi = log_pi
        self.num_states = num_states
        self.num_components = num_components
        self.covariance_type = covariance_type

    def log_obs(self, observations: torch.Tensor) -> torch.Tensor:
        """State emission scores ``(B, T, S)`` from the frozen tables."""
        if self.covariance_type == "full":
            # The logsumexp over components runs inside each time chunk.
            return fullcov_mixture_log_probs_prepared(
                observations, self.emission_tables, self.num_states, self.num_components)
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
    """GMM-HMM with diag / full / tied / spherical covariances.

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh one seeded with 0 when omitted) and moved to ``device``, the
    CUDA device unless the caller names another. Torch cannot reproduce
    the JAX package's ``nnx.Rngs`` draws, so weights are carried across
    with ``bridge.mixture_gaussian_state_dict`` where the two must agree.
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
        device="cuda",
    ):
        super().__init__()
        if covariance_type not in ("diag", "full", "tied", "spherical"):
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
        cov_shape = {"diag": (S, C, D), "full": (S, C, flat_dim(D)), "tied": (D,),
                     "spherical": (S, C)}
        cov = torch.zeros(cov_shape[covariance_type])
        if covariance_type == "full":
            # softplus(0.5413) + 1e-4 ≈ 1: unit initial variances.
            cov[..., _diag_slots(D)] = 0.5413
        self.cov_params = nn.Parameter(cov.to(device))

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
        """State scores ``(B, T, S)``, differentiable on both devices."""
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

        For full covariance the observation-independent tables
        (``emissions.fullcov_prepare``: the inverse Cholesky factors and
        precisions) are computed here, once, with the log mixture weights
        folded into ``log_norm``. Parameters are captured by value: after
        further training, call ``make_decoder()`` again for a fresh
        snapshot.
        """
        S, C, D = self.num_states, self.num_components, self.feature_dim
        log_w = torch.log_softmax(self.mixture_weights_logits, dim=-1)
        if self.covariance_type == "full":
            chol = tril_from_flat(self.cov_params.reshape(S * C, -1), D)
            tables = fullcov_prepare(self.means.reshape(S * C, D), chol)
            tables["log_norm"] = tables["log_norm"] + log_w.reshape(-1)
        else:
            tables = {
                "means": self.means.detach().clone(),
                "cov_params": self.cov_params.detach().clone(),
                "log_w": log_w,
            }
        return PreparedGMMDecoder(
            tables, self._log_a(), self._log_pi(), S, C, self.covariance_type,
        )

    def log_likelihood(
        self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Marginal sequence log-likelihood ``(B,)`` via the forward pass.

        With checkpointing on (``precision.set_checkpointing``), the
        ``(B, T, S, C)`` component scores are recomputed in the backward
        pass instead of kept across it."""

        def _score(o, means, cov_params, mixture_logits):
            return gmm_log_probs(o, means, cov_params, mixture_logits, self.covariance_type)

        log_obs = maybe_remat(_score)(
            observations, self.means, self.cov_params, self.mixture_weights_logits
        )
        return auto_log_likelihood(log_obs, self._log_a(), self._log_pi(), lengths)

    def compute_loss(
        self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Mean negative log-likelihood, for gradient training."""
        return -torch.mean(self.log_likelihood(observations, lengths))

    # -- EM (Baum-Welch) ----------------------------------------------------------
    @torch.no_grad()
    def em_step(self, observations: torch.Tensor, var_floor: float = 1e-3, mesh=None):
        """One exact Baum-Welch update from a batch of sequences, in place.

        E-step: forward-backward posteriors γ (``ops.auto_forward_backward``)
        and pairwise ξ, component responsibilities r = γ · p(c | x, s).
        M-step: closed-form weight, mean, covariance and transition
        updates. Returns the batch mean log-likelihood before the update.
        """
        if mesh is not None:
            raise NotImplementedError(
                "em_step(mesh=...) is not ported yet: ROADMAP queue 1 item 12 "
                "(parallel/ on torch.distributed)"
            )
        ll, new = _em_update(
            observations, self.means, self.cov_params, self.mixture_weights_logits,
            self._log_a(), self._log_pi(), self.covariance_type, var_floor,
            self.learnable_transitions,
        )
        self.means.copy_(new["means"])
        self.cov_params.copy_(new["cov_params"])
        self.mixture_weights_logits.copy_(new["mixture_logits"])
        if self.learnable_transitions:
            self.transition_logits.copy_(new["transition_logits"])
        return ll

    def get_model_info(self) -> dict:
        """Configuration and parameter statistics (full covariance counts
        its ``(S, C, D(D+1)/2)`` Cholesky parameters)."""
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


def _diag_slots(d: int) -> list:
    """Positions of the diagonal in a flattened row-major lower triangle."""
    return [i * (i + 1) // 2 + i for i in range(d)]


def _em_update(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    mixture_logits: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    covariance_type: str,
    var_floor: float,
    learnable_transitions: bool,
):
    """One Baum-Welch step: ``(mean log Z, new parameters)``, the new
    parameters keyed ``means``, ``cov_params``, ``mixture_logits`` and,
    with learnable transitions, ``transition_logits``."""
    comp = gmm_component_log_probs(obs, means, cov_params, covariance_type)
    log_w = torch.log_softmax(mixture_logits, dim=-1)
    weighted = comp + log_w                                  # (B, T, S, C)
    log_obs = logsumexp(weighted, dim=-1)                    # (B, T, S)
    # The E-step runs on emissions shifted by each frame's max, which
    # cancels out of γ and ξ but keeps alpha and beta at O(1e3) instead
    # of O(1e5), where f32 rounding would cost ξ ~1e-2 (the JAX package
    # shifts inside auto_forward_backward and re-adds the shift before
    # taking ξ); the shift is added back to log Z.
    shift = torch.amax(log_obs, dim=-1, keepdim=True)
    lo_hat = log_obs - shift
    log_gamma, alpha_hat, beta_hat, lz_hat = auto_forward_backward(lo_hat, log_a, log_pi)

    # Component responsibilities: r = γ_s · p(c | x, s).
    r = torch.exp(log_gamma[..., None] + weighted - log_obs[..., None])
    r_sum = torch.sum(r, dim=(0, 1)) + 1e-10                 # (S, C)
    new_w = r_sum / torch.sum(r_sum, dim=-1, keepdim=True)
    new_means = torch.einsum("btsc,btd->scd", r, obs) / r_sum[..., None]
    ex2 = torch.einsum("btsc,btd->scd", r, obs * obs) / r_sum[..., None]
    var_diag = torch.clamp(ex2 - new_means**2, min=var_floor)  # (S, C, D)

    if covariance_type == "diag":
        new_cov = torch.log(var_diag)
    elif covariance_type == "spherical":
        new_cov = torch.log(torch.mean(var_diag, dim=-1))
    elif covariance_type == "tied":
        w = r_sum / torch.sum(r_sum)
        new_cov = torch.log(torch.einsum("sc,scd->d", w, var_diag))
    elif covariance_type == "full":
        D = obs.shape[-1]
        exx = torch.einsum("btsc,btd,bte->scde", r, obs, obs) / r_sum[..., None, None]
        cov = exx - new_means[..., :, None] * new_means[..., None, :]
        cov = cov + var_floor * torch.eye(D, dtype=cov.dtype, device=cov.device)
        chol = torch.linalg.cholesky(cov)                    # (S, C, D, D)
        rows, cols = torch.tril_indices(D, D, device=chol.device)
        new_cov = chol[..., rows, cols]
        # Invert tril_from_flat's softplus diagonal, y = softplus(x): x =
        # log(expm1(y)), written y + log(-expm1(-y)) so it cannot overflow.
        y = torch.clamp(torch.diagonal(chol, dim1=-2, dim2=-1) - 1e-4, min=1e-6)
        new_cov[..., _diag_slots(D)] = y + torch.log(-torch.expm1(-y))
    else:
        raise ValueError(f"Unknown covariance_type: {covariance_type}")

    new = {
        "means": new_means,
        "cov_params": new_cov,
        "mixture_logits": torch.log(new_w + 1e-10),
    }
    if learnable_transitions:
        if log_obs.shape[-1] > MAX_SMALLK:
            # The product form: no (B, T-1, S, S) table.
            a_new = core.xi_sum(alpha_hat, beta_hat, lo_hat, log_a)
        else:
            xi = core.xi_expectations(alpha_hat, beta_hat, lo_hat, log_a, lz_hat)
            a_new = torch.sum(torch.exp(xi), dim=0)          # Σ_b Σ_t ξ_t
        a_new = a_new / (torch.sum(a_new, dim=-1, keepdim=True) + 1e-10)
        new["transition_logits"] = torch.log(a_new + 1e-10)
    return torch.mean(lz_hat + shift.sum(dim=(1, 2))), new
