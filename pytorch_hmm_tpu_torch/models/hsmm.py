"""HSMMLayer / DurationConstrainedHMM — explicit-duration models.

Port of ``pytorch_hmm_tpu/models/hsmm.py`` as ``nn.Module``s:

* ``HSMMLayer``: no-self-loop transitions, gamma / Poisson / Weibull
  duration pmfs with softplus parameters (learnable, or fixed buffers),
  diagonal-Gaussian emissions; segment Viterbi decode (``forward``),
  the differentiable likelihood (``log_likelihood``, ``compute_loss``),
  exact posteriors, a closed-form Baum-Welch ``em_step`` and ancestral
  sampling;
* ``DurationConstrainedHMM``: MLP emissions and soft min/max duration
  penalties expressed as a duration log-score in the same segment DP.

On CUDA tensors the emissions go through ``ops.emit.diag_quadratic`` and
the segment DP through the ``ops.hsmm_smallk`` kernels (``ops.auto_hsmm_*``).
Distributed EM (``em_step(mesh=...)``) comes with ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..durations import (
    gamma_duration_log_pmf,
    poisson_duration_log_pmf,
    weibull_duration_log_pmf,
)
from ..emissions import diag_gaussian_log_probs
from ..ops import auto_hsmm_log_z, auto_hsmm_posteriors, auto_hsmm_viterbi
from ..trace import span

__all__ = ["HSMMLayer", "DurationConstrainedHMM"]

_MESH_TODO = ("em_step(mesh=...) is not ported yet: ROADMAP queue 1 item 12 "
              "(parallel/ on torch.distributed)")

# Raw (pre-softplus) duration parameter names and initial values of each
# family (mean duration ~10 frames).
_DURATION_PARAMS = {
    "gamma": (("duration_shape", 2.0), ("duration_rate", 0.2)),
    "poisson": (("duration_lambda", 10.0),),
    "weibull": (("duration_scale", 10.0), ("duration_concentration", 2.0)),
}


def _masked_log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Row log-softmax with a ``-inf`` diagonal: no self-transitions."""
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    return torch.log_softmax(logits.masked_fill(eye, float("-inf")), dim=-1)


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """``x`` with ``softplus(x) = y``, for ``y`` floored at 1e-4. Written
    ``y + log(-expm1(-y))`` rather than ``log(expm1(y))``, which is the
    same value but overflows to inf in f32 for y > 88 (a gamma shape
    m²/v of a near-deterministic duration gets there)."""
    y = torch.clamp(y, min=1e-4)
    return y + torch.log(-torch.expm1(-y))


def _posterior_duration_moments(dur_counts: torch.Tensor):
    """Mean and variance (floored at 0.25) of each state's posterior
    duration distribution, from expected per-duration segment counts
    ``(S, D)``."""
    dc = torch.clamp(dur_counts, min=0.0) + 1e-10
    d = torch.arange(1, dc.shape[-1] + 1, dtype=dc.dtype, device=dc.device)
    p_d = dc / torch.sum(dc, dim=-1, keepdim=True)
    m = torch.sum(p_d * d, dim=-1)
    v = torch.clamp(torch.sum(p_d * d**2, dim=-1) - m**2, min=0.25)
    return m, v


def _transition_logits_from_counts(trans_counts: torch.Tensor) -> torch.Tensor:
    """Normalized expected segment-transition counts; the diagonal stays
    structurally zero."""
    S = trans_counts.shape[0]
    tc = torch.clamp(trans_counts, min=0.0) + 1e-10
    tc = tc * (1.0 - torch.eye(S, dtype=tc.dtype, device=tc.device))
    return torch.log(tc / torch.sum(tc, dim=-1, keepdim=True))


class HSMMLayer(nn.Module):
    """Hidden semi-Markov model with explicit state durations.

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh one seeded with 0 when omitted) and moved to ``device``, the
    CUDA device unless the caller names another. Torch cannot reproduce the
    JAX package's ``nnx.Rngs`` draws, so weights are carried across with
    ``bridge.hsmm_layer_state_dict`` where the two must agree. With
    ``learnable_duration_params=False`` the duration parameters are
    buffers that neither gradients nor ``em_step`` touch.
    """

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        duration_distribution: str = "gamma",
        max_duration: int = 50,
        learnable_duration_params: bool = True,
        min_duration: int = 1,
        normalize_durations: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        if duration_distribution not in _DURATION_PARAMS:
            raise ValueError(f"Unknown duration distribution: {duration_distribution}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.duration_distribution = duration_distribution
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.learnable_duration_params = learnable_duration_params
        self.normalize_durations = normalize_durations
        self.eps = 1e-8

        S, Fd = num_states, feature_dim
        self.transition_logits = nn.Parameter(
            torch.randn((S, S), generator=generator).to(device) * 0.1)
        self.observation_means = nn.Parameter(
            torch.randn((S, Fd), generator=generator).to(device) * 0.1)
        self.observation_log_vars = nn.Parameter(torch.zeros((S, Fd), device=device))
        for name, value in _DURATION_PARAMS[duration_distribution]:
            raw = torch.full((S,), math.log(math.expm1(value)), device=device)
            if learnable_duration_params:
                setattr(self, name, nn.Parameter(raw))
            else:
                self.register_buffer(name, raw)

    def _duration_tensors(self):
        return [getattr(self, name) for name, _ in _DURATION_PARAMS[self.duration_distribution]]

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> torch.Tensor:
        """Softmax transitions with a hard-zero diagonal."""
        return torch.exp(self._log_a())

    def _log_a(self) -> torch.Tensor:
        with span("models.hsmm.transitions"):
            return _masked_log_softmax(self.transition_logits)

    def _log_pi(self) -> torch.Tensor:
        # Uniform initial distribution: every state's first segment
        # scores equally.
        with span("models.hsmm.transitions"):
            return torch.full((self.num_states,), -math.log(self.num_states),
                              device=self.transition_logits.device)

    def get_duration_log_probs(self) -> torch.Tensor:
        """(S, D) duration log-pmf."""
        kw = dict(max_duration=self.max_duration, min_duration=self.min_duration,
                  normalize=self.normalize_durations)
        pmf = {"gamma": gamma_duration_log_pmf, "poisson": poisson_duration_log_pmf,
               "weibull": weibull_duration_log_pmf}[self.duration_distribution]
        with span("models.hsmm.durations"):
            return pmf(*[F.softplus(p) for p in self._duration_tensors()], **kw)

    def get_duration_probabilities(self) -> torch.Tensor:
        """(S, D) probabilities."""
        return torch.exp(self.get_duration_log_probs())

    def get_observation_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        """(B, T, S) diagonal-Gaussian scores."""
        with span("models.hsmm.emissions"):
            return diag_gaussian_log_probs(observations, self.observation_means,
                                           self.observation_log_vars)

    def _dp_args(self, observations):
        return (self.get_observation_log_probs(observations), self._log_a(), self._log_pi(),
                self.get_duration_log_probs())

    # -- inference ------------------------------------------------------------
    @torch.no_grad()
    def viterbi_decode_hsmm(
        self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Best segmentation: ``(states (B, T) int32, scores (B,))``.
        ``lengths (B,)`` masks ragged batches (padded frames repeat each
        row's final state)."""
        with span("models.hsmm.decode"):
            return auto_hsmm_viterbi(*self._dp_args(observations), lengths)

    def forward(self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        return self.viterbi_decode_hsmm(observations, lengths)

    def log_likelihood(
        self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Marginal log-likelihood over all segmentations ``(B,)``,
        differentiable."""
        with span("models.hsmm.log_likelihood"):
            return auto_hsmm_log_z(*self._dp_args(observations), lengths)

    def compute_loss(
        self, observations: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return -torch.mean(self.log_likelihood(observations, lengths))

    @torch.no_grad()
    def em_step(self, observations: torch.Tensor, var_floor: float = 1e-3,
                lengths: Optional[torch.Tensor] = None, mesh=None):
        """One Baum-Welch update, in place; returns the mean
        log-likelihood before it.

        E-step: frame occupancy, segment-transition counts and
        per-duration segment counts as gradients of ``log Z``. M-step:
        occupancy-weighted Gaussian moments; normalized transition
        counts; durations by moment matching the posterior duration
        distribution (gamma: shape = m²/v, rate = m/v; Poisson: λ = m;
        Weibull: the scale that matches the mean at the current
        concentration), only when they are learnable. ``lengths (B,)``
        restricts every statistic to each row's valid prefix.
        """
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        obs = observations if observations.ndim == 3 else observations[None]
        w, sx, sx2, trans_counts, _, dur_counts, lz_mean = _hsmm_em_stats_reduced(
            obs, self.observation_means, self.observation_log_vars, self._log_a(),
            self._log_pi(), self.get_duration_log_probs(), lengths)

        mean = sx / w[:, None]
        var = torch.clamp(sx2 / w[:, None] - mean**2, min=var_floor)
        self.observation_means.copy_(mean)
        self.observation_log_vars.copy_(torch.log(var))
        self.transition_logits.copy_(_transition_logits_from_counts(trans_counts))
        if not self.learnable_duration_params:
            return lz_mean
        m, v = _posterior_duration_moments(dur_counts)
        if self.duration_distribution == "gamma":
            self.duration_shape.copy_(_inv_softplus(m * m / v))
            self.duration_rate.copy_(_inv_softplus(m / v))
        elif self.duration_distribution == "poisson":
            self.duration_lambda.copy_(_inv_softplus(m))
        else:
            conc = F.softplus(self.duration_concentration)
            self.duration_scale.copy_(_inv_softplus(m / torch.exp(torch.lgamma(1.0 + 1.0 / conc))))
        return lz_mean

    @torch.no_grad()
    def posteriors(self, observations: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None) -> dict:
        """Frame occupancy and segment boundary posteriors (``gamma``,
        ``segment_start``, ``segment_end``, ``log_z``); zero at padded
        frames when ``lengths`` is given."""
        return auto_hsmm_posteriors(*self._dp_args(observations), lengths)

    # -- generation ------------------------------------------------------------
    @torch.no_grad()
    def generate_sequence(
        self, length: int, initial_state: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling: ``(states (length,), obs (length, F))``.
        A segment's duration is drawn when it opens; when it is used up
        the next state is drawn from the no-self-loop transitions.
        ``generator`` lives on the layer's device."""
        dev = self.transition_logits.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dur_p = torch.exp(self.get_duration_log_probs())
        trans_p = torch.exp(self._log_a())

        def draw(p):
            return int(torch.multinomial(p, 1, generator=generator))

        states = torch.empty(length, dtype=torch.long, device=dev)
        state, left = initial_state, 1 + draw(dur_p[initial_state])
        for t in range(length):
            if left <= 0:
                state = draw(trans_p[state])
                left = 1 + draw(dur_p[state])
            states[t] = state
            left -= 1
        noise = torch.randn((length, self.feature_dim), generator=generator, device=dev)
        stds = torch.exp(0.5 * self.observation_log_vars)
        return states, self.observation_means[states] + stds[states] * noise

    # -- introspection ----------------------------------------------------------
    def get_expected_durations(self) -> torch.Tensor:
        """Closed-form expected duration per state."""
        p = [F.softplus(t) for t in self._duration_tensors()]
        if self.duration_distribution == "gamma":
            return p[0] / p[1]
        if self.duration_distribution == "poisson":
            return p[0]
        return p[0] * torch.exp(torch.lgamma(1.0 + 1.0 / p[1]))

    def get_model_info(self) -> dict:
        """Configuration and parameter counts: ``total_parameters``
        counts the duration buffers of a fixed-duration layer too,
        ``trainable_parameters`` only the ``nn.Parameter``s."""
        trainable = sum(p.numel() for p in self.parameters())
        fixed = 0 if self.learnable_duration_params else sum(
            t.numel() for t in self._duration_tensors())
        return {
            "model_type": "HSMM",
            "num_states": self.num_states,
            "feature_dim": self.feature_dim,
            "duration_distribution": self.duration_distribution,
            "max_duration": self.max_duration,
            "min_duration": self.min_duration,
            "expected_durations": self.get_expected_durations().tolist(),
            "total_parameters": int(trainable + fixed),
            "trainable_parameters": int(trainable),
            "learnable_durations": self.learnable_duration_params,
        }


class DurationConstrainedHMM(nn.Module):
    """HMM with MLP emissions and soft min/max duration penalties.

    The penalty ``-w·max(0, min_d − d) − w·max(0, d − max_d)`` is a
    duration log-score over a grid of ``max_duration + duration_slack``
    frames, decoded by the shared segment DP.
    """

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        min_duration: int = 3,
        max_duration: int = 30,
        hidden_dim: int = 128,
        duration_penalty_weight: float = 0.1,
        duration_slack: int = 10,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.duration_penalty_weight = duration_penalty_weight
        # Segments may exceed max_duration at a penalty; bound the DP grid.
        self.duration_grid = max_duration + duration_slack
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.transition_logits = nn.Parameter(
            torch.randn((num_states, num_states), generator=generator).to(device) * 0.1)
        self.emission_net = nn.Sequential(
            nn.Linear(feature_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, num_states),
        ).to(device)

    def _duration_log_score(self) -> torch.Tensor:
        d = torch.arange(1, self.duration_grid + 1, dtype=torch.float32,
                         device=self.transition_logits.device)
        w = self.duration_penalty_weight
        pen = w * torch.clamp(self.min_duration - d, min=0.0) \
            + w * torch.clamp(d - self.max_duration, min=0.0)
        return (-pen).expand(self.num_states, self.duration_grid)

    def _log_a(self) -> torch.Tensor:
        return _masked_log_softmax(self.transition_logits)

    @torch.no_grad()
    def forward(self, observations: torch.Tensor) -> torch.Tensor:
        """Decoded states ``(B, T)``."""
        log_obs = torch.log_softmax(self.emission_net(observations), dim=-1)
        log_pi = torch.full((self.num_states,), -math.log(self.num_states),
                            device=log_obs.device)
        states, _ = auto_hsmm_viterbi(log_obs, self._log_a(), log_pi, self._duration_log_score())
        return states


def _hsmm_em_stats(log_obs, log_a, log_pi, log_dur, lengths=None):
    """E-step statistics as gradients of ``log Z``: frame occupancy
    (``log_obs``), segment-transition counts (``log_a``), initial-state
    counts (``log_pi``) and per-duration segment counts (``log_dur``),
    zero at padded frames. Returns ``(occupancy, trans_counts,
    pi_counts, dur_counts, log_z)``."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(True) for t in (log_obs, log_a, log_pi, log_dur)]
        lz = auto_hsmm_log_z(*args, lengths)
        grads = torch.autograd.grad(lz.sum(), args)
    return (*grads, lz.detach())


def _hsmm_em_stats_reduced(obs, means, log_vars, log_a, log_pi, log_dur, lengths=None):
    """E-step statistics summed over the batch and frames: ``(w (S,),
    sx (S, F), sx2 (S, F), trans_counts (S, S), pi_counts (S,),
    dur_counts (S, D), mean log Z)``; ``w`` is the occupancy mass,
    ``sx`` and ``sx2`` the occupancy-weighted first and second
    moments."""
    log_obs = diag_gaussian_log_probs(obs, means, log_vars)
    gamma, tc, pc, dc, lz = _hsmm_em_stats(log_obs, log_a, log_pi, log_dur, lengths)
    w = torch.sum(gamma, dim=(0, 1))
    sx = torch.einsum("bts,btd->sd", gamma, obs)
    sx2 = torch.einsum("bts,btd->sd", gamma, obs * obs)
    return w + 1e-10, sx, sx2, tc, pc, dc, torch.sum(lz) / obs.shape[0]
