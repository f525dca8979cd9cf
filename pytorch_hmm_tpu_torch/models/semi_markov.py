"""DurationModel / SemiMarkovHMM / AdaptiveDurationHSMM.

Port of ``pytorch_hmm_tpu/models/semi_markov.py`` as ``nn.Module``s: a
standalone per-state duration module (gamma, Poisson, Gaussian or a
neural softmax over the duration grid), a segment HMM with supervised
and unsupervised forward, likelihood, Baum-Welch ``em_step``,
posteriors, Viterbi decode and sampling, and a context-conditioned
variant.

Every unsupervised path runs the segment DP through ``ops``: the forward
tables from ``ops.auto_hsmm_forward`` (``hsmm_smallk_forward`` on the
card), the likelihood through
``ops.auto_hsmm_log_z``, decode through ``ops.auto_hsmm_viterbi`` and
posteriors through ``ops.auto_hsmm_posteriors`` (the JAX package calls
its plain ``core.hsmm_forward`` scan for the forward tables and the
likelihood; the values are the same). The ``neural`` observation model
is a gaussian ``NeuralObservationModel`` (``models/neural.py``; in eval
mode its scores come from the ``fused_gaussian_emission`` kernel on the
card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..durations import (
    gamma_duration_log_pmf,
    gaussian_duration_log_pmf,
    poisson_duration_log_pmf,
)
from ..emissions import diag_gaussian_log_probs
from ..ops import auto_hsmm_forward, auto_hsmm_log_z, auto_hsmm_posteriors, auto_hsmm_viterbi
from .hsmm import (
    _MESH_TODO,
    _hsmm_em_stats_reduced,
    _inv_softplus,
    _masked_log_softmax,
    _posterior_duration_moments,
    _transition_logits_from_counts,
)
from .neural import NeuralObservationModel

__all__ = ["DurationModel", "SemiMarkovHMM", "AdaptiveDurationHSMM"]

def _randn(generator, *shape, device):
    return torch.randn(shape, generator=generator).to(device)


class DurationModel(nn.Module):
    """Per-state duration distribution: ``gamma``, ``poisson`` or
    ``gaussian`` parametric, or ``neural`` (a state embedding through an
    MLP into a softmax over the duration grid)."""

    def __init__(
        self,
        num_states: int,
        max_duration: int = 50,
        distribution_type: str = "gamma",
        min_duration: int = 1,
        hidden_dim: int = 128,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.num_states = num_states
        self.max_duration = max_duration
        self.distribution_type = distribution_type
        self.min_duration = min_duration
        self.hidden_dim = hidden_dim
        S = num_states
        if distribution_type == "gamma":
            self.alpha_params = nn.Parameter(torch.ones((S,), device=device))
            self.beta_params = nn.Parameter(torch.ones((S,), device=device))
        elif distribution_type == "poisson":
            self.lambda_params = nn.Parameter(torch.full((S,), 5.0, device=device))
        elif distribution_type == "gaussian":
            self.mean_params = nn.Parameter(torch.full((S,), 10.0, device=device))
            self.std_params = nn.Parameter(torch.ones((S,), device=device))
        elif distribution_type == "neural":
            # Drawn on the CPU and moved, so the draws are the CPU's on any device.
            self.state_embedding = nn.Embedding(S, hidden_dim).to(device)
            self.net = nn.Sequential(
                nn.Linear(hidden_dim, hidden_dim),
                nn.ReLU(),
                nn.Linear(hidden_dim, max_duration),
            ).to(device)
        else:
            raise ValueError(f"Unknown distribution_type: {distribution_type}")

    def log_pmf_table(self) -> torch.Tensor:
        """(S, D) duration log-pmf of every state: the table the segment
        DP reads."""
        kw = dict(max_duration=self.max_duration, min_duration=self.min_duration)
        sp = F.softplus
        if self.distribution_type == "gamma":
            return gamma_duration_log_pmf(sp(self.alpha_params) + 1e-6,
                                          sp(self.beta_params) + 1e-6, **kw)
        if self.distribution_type == "poisson":
            return poisson_duration_log_pmf(sp(self.lambda_params) + 1e-6, **kw)
        if self.distribution_type == "gaussian":
            # The mean is softplus-shifted by min_duration.
            return gaussian_duration_log_pmf(sp(self.mean_params) + self.min_duration,
                                             sp(self.std_params) + 1e-6, **kw)
        emb = self.state_embedding.weight
        log_p = torch.log_softmax(self.net(emb), dim=-1)
        d = torch.arange(1, self.max_duration + 1, device=log_p.device)
        return torch.where(d >= self.min_duration, log_p, float("-inf"))

    def forward(self, state_indices: torch.Tensor,
                durations: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Duration log-probs: the full distributions ``(..., D)`` of
        each state index, or with ``durations`` the log-prob of each
        (state, duration) pair; durations off the grid score ``-inf``."""
        out = self.log_pmf_table()[state_indices]
        if durations is None:
            return out
        idx = torch.clamp(durations - 1, 0, self.max_duration - 1).long()
        scored = out.gather(-1, idx[..., None])[..., 0]
        in_grid = (durations >= 1) & (durations <= self.max_duration)
        return torch.where(in_grid, scored, float("-inf"))

    @torch.no_grad()
    def sample(self, state_indices: torch.Tensor, num_samples: int = 1,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Durations drawn from the truncated pmf: ``(B,)``, or ``(B,
        num_samples)``."""
        table = self.log_pmf_table()[state_indices]
        if generator is None:
            generator = torch.Generator(device=table.device).manual_seed(0)
        draws = torch.multinomial(torch.exp(table), num_samples, replacement=True,
                                  generator=generator) + 1
        return draws[:, 0] if num_samples == 1 else draws


class SemiMarkovHMM(nn.Module):
    """Segment HMM with a duration model and a Gaussian (per-state means
    and log-variances) or neural (``NeuralObservationModel``, gaussian
    head) observation model."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        max_duration: int = 50,
        duration_distribution: str = "gamma",
        observation_model: str = "gaussian",
        min_duration: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        if observation_model not in ("gaussian", "neural"):
            raise ValueError(f"Unknown observation_model: {observation_model}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.observation_model_type = observation_model
        self.duration_model = DurationModel(
            num_states, max_duration, duration_distribution, min_duration,
            generator=generator, device=device)
        self.transition_logits = nn.Parameter(_randn(generator, num_states, num_states,
                                                     device=device))
        self.initial_logits = nn.Parameter(torch.zeros((num_states,), device=device))
        if observation_model == "gaussian":
            self.observation_means = nn.Parameter(_randn(generator, num_states, observation_dim,
                                                         device=device))
            self.observation_logvars = nn.Parameter(
                torch.zeros((num_states, observation_dim), device=device))
        else:
            self.neural_obs_model = NeuralObservationModel(
                num_states, observation_dim, model_type="gaussian", generator=generator,
                device=device)

    # -- parameter views ------------------------------------------------------
    def _log_a(self) -> torch.Tensor:
        # Self-loops are impossible in a segment model: mask the diagonal.
        return _masked_log_softmax(self.transition_logits)

    def _log_pi(self) -> torch.Tensor:
        return torch.log_softmax(self.initial_logits, dim=-1)

    def observation_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        """(B, T, S) per-frame scores from the configured emission model."""
        if self.observation_model_type == "neural":
            return self.neural_obs_model.log_probs(observations)
        return diag_gaussian_log_probs(observations, self.observation_means,
                                       self.observation_logvars)

    def _dp_args(self, observations, log_dur=None):
        if log_dur is None:
            log_dur = self.duration_model.log_pmf_table()
        return self.observation_log_probs(observations), self._log_a(), self._log_pi(), log_dur

    # -- forward ---------------------------------------------------------------
    def forward(self, observations: torch.Tensor,
                state_sequence: Optional[torch.Tensor] = None,
                duration_sequence: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Supervised (given the segmentation) or unsupervised (marginal)
        forward; a dict with ``log_probability`` and mode-specific
        extras."""
        if observations.ndim == 2:
            observations = observations[None]
        if state_sequence is not None and duration_sequence is not None:
            return self._supervised_forward(observations, state_sequence, duration_sequence)
        return self._unsupervised_forward(observations)

    def _supervised_forward(self, observations, state_sequence, duration_sequence):
        _, T, _ = observations.shape
        if state_sequence.ndim == 1:
            state_sequence = state_sequence[None]
            duration_sequence = duration_sequence[None]
        state_sequence = state_sequence.long()
        N = state_sequence.shape[1]
        # Frame t belongs to the first segment whose cumulative end
        # exceeds t.
        seg_end = torch.cumsum(duration_sequence, dim=1)              # (B, N)
        t_idx = torch.arange(T, device=observations.device)[None, :, None]
        seg_of_frame = torch.clamp(torch.sum(t_idx >= seg_end[:, None, :], dim=-1), 0, N - 1)
        frame_states = state_sequence.gather(1, seg_of_frame)
        log_obs = self.observation_log_probs(observations)
        valid = t_idx[..., 0] < seg_end[:, -1:]
        per_frame = log_obs.gather(-1, frame_states[..., None])[..., 0]
        log_observation = torch.sum(torch.where(valid, per_frame, 0.0), dim=1)
        log_duration = torch.sum(self.duration_model(state_sequence, duration_sequence), dim=1)
        # The diagonal-masked transitions of the unsupervised DP: a
        # segmentation with s_t == s_{t+1} scores -inf.
        trans = self._log_a()[state_sequence[:, :-1], state_sequence[:, 1:]]
        log_transition = torch.sum(trans, dim=1) + self._log_pi()[state_sequence[:, 0]]
        return {
            "log_probability": log_observation + log_duration + log_transition,
            "log_observation": log_observation,
            "log_duration": log_duration,
            "log_transition": log_transition,
        }

    def _unsupervised_forward(self, observations):
        args = self._dp_args(observations)
        log_alpha, _ = auto_hsmm_forward(*(t.detach() for t in args))
        return {"log_probability": auto_hsmm_log_z(*args), "forward_variables": log_alpha}

    def log_likelihood(self, observations: torch.Tensor) -> torch.Tensor:
        if observations.ndim == 2:
            observations = observations[None]
        return auto_hsmm_log_z(*self._dp_args(observations))

    def compute_loss(self, observations: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_likelihood(observations))

    @torch.no_grad()
    def em_step(self, observations: torch.Tensor, var_floor: float = 1e-3,
                lengths: Optional[torch.Tensor] = None, mesh=None):
        """One Baum-Welch update (Gaussian observations, parametric
        durations), in place; returns the mean log-likelihood before it.
        The M-step mirrors ``HSMMLayer.em_step`` and also re-estimates
        the initial distribution; a Gaussian duration model takes the
        posterior duration mean and standard deviation."""
        if self.observation_model_type != "gaussian":
            raise NotImplementedError("em_step requires gaussian emissions")
        if self.duration_model.distribution_type == "neural":
            raise NotImplementedError("em_step requires a parametric duration model")
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        obs = observations if observations.ndim == 3 else observations[None]
        w, sx, sx2, trans_counts, pi_counts, dur_counts, lz_mean = _hsmm_em_stats_reduced(
            obs, self.observation_means, self.observation_logvars, self._log_a(),
            self._log_pi(), self.duration_model.log_pmf_table(), lengths)

        mean = sx / w[:, None]
        self.observation_means.copy_(mean)
        self.observation_logvars.copy_(torch.log(torch.clamp(sx2 / w[:, None] - mean**2,
                                                             min=var_floor)))
        self.transition_logits.copy_(_transition_logits_from_counts(trans_counts))
        pc = torch.clamp(pi_counts, min=0.0) + 1e-10
        self.initial_logits.copy_(torch.log(pc / torch.sum(pc)))

        m, v = _posterior_duration_moments(dur_counts)
        dm = self.duration_model
        if dm.distribution_type == "gamma":
            dm.alpha_params.copy_(_inv_softplus(m * m / v))
            dm.beta_params.copy_(_inv_softplus(m / v))
        elif dm.distribution_type == "poisson":
            dm.lambda_params.copy_(_inv_softplus(m))
        else:
            dm.mean_params.copy_(_inv_softplus(torch.clamp(m - dm.min_duration, min=1e-3)))
            dm.std_params.copy_(_inv_softplus(torch.sqrt(v)))
        return lz_mean

    @torch.no_grad()
    def posteriors(self, observations: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Exact frame occupancy and segment boundary posteriors."""
        if observations.ndim == 2:
            observations = observations[None]
        return auto_hsmm_posteriors(*self._dp_args(observations))

    # -- decoding ---------------------------------------------------------------
    @torch.no_grad()
    def viterbi_decode(self, observations: torch.Tensor):
        """Best segmentation. ``(T, F)`` input gives ``(states (N,),
        durations (N,), log_prob)``, the frame path run-length encoded
        into segments; ``(B, T, F)`` gives ``(path (B, T), None, scores
        (B,))``."""
        unbatched = observations.ndim == 2
        obs = observations[None] if unbatched else observations
        path, score = auto_hsmm_viterbi(*self._dp_args(obs))
        if not unbatched:
            return path, None, score
        p = path[0]
        change = torch.nonzero(p[1:] != p[:-1]).flatten() + 1
        starts = torch.cat([change.new_zeros(1), change])
        ends = torch.cat([change, change.new_full((1,), p.shape[0])])
        return p[starts], ends - starts, score[0]

    # -- sampling ---------------------------------------------------------------
    @torch.no_grad()
    def sample(self, num_states: int, max_length: int = 100,
               generator: Optional[torch.Generator] = None):
        """Sample ``num_states`` segments: ``(state_sequence (N,),
        duration_sequence (N,), observations (L, F))``, the total length
        capped at ``max_length`` (durations past the cap are cut,
        trailing segments get duration 0). Segment chains obey the
        no-self-transition structure the DP scores with."""
        if self.observation_model_type != "gaussian":
            raise NotImplementedError("sampling requires the gaussian observation model")
        dev = self.transition_logits.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        trans_p = torch.exp(self._log_a())
        dur_p = torch.exp(self.duration_model.log_pmf_table())

        def draw(p):
            return int(torch.multinomial(p, 1, generator=generator))

        state, used = draw(torch.exp(self._log_pi())), 0
        states, durations = [], []
        for _ in range(num_states):
            dur = min(1 + draw(dur_p[state]), max(max_length - used, 0))
            states.append(state)
            durations.append(dur)
            used += dur
            state = draw(trans_p[state])
        states = torch.tensor(states, device=dev)
        durations = torch.tensor(durations, device=dev)
        frame_states = torch.repeat_interleave(states, durations)
        noise = torch.randn((frame_states.shape[0], self.observation_dim),
                            generator=generator, device=dev)
        stds = torch.exp(0.5 * self.observation_logvars[frame_states])
        return states, durations, self.observation_means[frame_states] + stds * noise


class AdaptiveDurationHSMM(SemiMarkovHMM):
    """SemiMarkovHMM whose duration distribution is conditioned on an
    external context vector."""

    def __init__(self, num_states: int, observation_dim: int, context_dim: int,
                 hidden_dim: int = 128, *, generator: Optional[torch.Generator] = None,
                 device="cuda", **kwargs):
        super().__init__(num_states, observation_dim, generator=generator, device=device,
                         **kwargs)
        self.context_dim = context_dim
        self.state_embedding = nn.Embedding(num_states, num_states).to(device)
        self.context_duration_net = nn.Sequential(
            nn.Linear(context_dim + num_states, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, self.max_duration),
        ).to(device)

    def compute_contextual_duration_probs(self, state_indices: torch.Tensor,
                                          context: torch.Tensor) -> torch.Tensor:
        """Context-conditioned duration log-pmf ``(..., D)``."""
        emb = self.state_embedding(state_indices)
        logits = self.context_duration_net(torch.cat([context, emb], dim=-1))
        return torch.log_softmax(logits, dim=-1)

    def contextual_log_likelihood(self, observations: torch.Tensor,
                                  context: torch.Tensor) -> torch.Tensor:
        """Marginal likelihood with the context-conditioned duration pmf
        in the segment DP."""
        if observations.ndim == 2:
            observations = observations[None]
        all_states = torch.arange(self.num_states, device=observations.device)
        log_dur = self.compute_contextual_duration_probs(
            all_states, context.expand(self.num_states, self.context_dim))
        return auto_hsmm_log_z(*self._dp_args(observations, log_dur))
