"""HMMLayer / GaussianHMMLayer — trainable HMM modules.

Port of ``pytorch_hmm_tpu/models/hmm_layer.py`` as ``nn.Module``s, on the
CUDA device unless ``device`` names another. Inference runs through the
dispatch (``ops.auto_forward_backward``, ``auto_viterbi``,
``auto_log_likelihood``): on CUDA the hand kernels (small-K to 32
states, ``ops.scan``'s general-K kernels to 1024, its prob-space kernels
for long unragged sequences to 128), on CPU the plain ``core``.

* Training mode (``.train()``, the default) gives soft posteriors by
  forward-backward; eval mode gives one-hot Viterbi alignments unless
  ``viterbi_inference=False``.
* The unsupervised ``compute_loss`` (negative mean log-likelihood)
  differentiates on every device, through the likelihood's autograd
  Functions on CUDA.
* Posteriors record a gradient only on CPU, through the plain ``core``:
  the kernels have no VJP (nor have the JAX package's), so on CUDA the
  supervised ``compute_loss(target_alignment=)`` and training-mode
  ``__call__`` of tensors that require a gradient raise
  ``NotImplementedError``; call them under ``torch.no_grad()`` there.
* Decodes (eval-mode ``__call__``, ``HMMLayer.align``) record no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from .. import core
from ..core.semiring import safe_log
from ..emissions import gaussian_log_probs
from ..ops import auto_forward_backward, auto_log_likelihood, auto_viterbi
from ..precision import maybe_remat
from ..utils import create_left_to_right_matrix, create_transition_matrix

__all__ = ["GaussianHMMLayer", "HMMLayer"]


class HMMLayer(nn.Module):
    """Trainable-transition HMM layer over per-state observation scores
    ``(B, T, K)`` (or ``(T, K)``), squashed by a sigmoid unless
    ``apply_sigmoid=False``. With ``learnable_transitions=False`` the
    initial matrix is kept as the ``transition_matrix`` buffer."""

    def __init__(
        self,
        num_states: int,
        learnable_transitions: bool = True,
        transition_type: str = "left_to_right",
        self_loop_prob: float = 0.7,
        viterbi_inference: bool = True,
        apply_sigmoid: bool = True,
        *,
        device="cuda",
    ):
        super().__init__()
        self.num_states = num_states
        self.learnable_transitions = learnable_transitions
        self.viterbi_inference = viterbi_inference
        self.apply_sigmoid = apply_sigmoid
        if transition_type == "left_to_right":
            p_init = create_left_to_right_matrix(num_states, self_loop_prob)
        else:
            p_init = create_transition_matrix(num_states, transition_type, self_loop_prob)
        p_init = p_init.to(device)
        if learnable_transitions:
            self.transition_logits = nn.Parameter(safe_log(p_init))
        else:
            self.register_buffer("transition_matrix", p_init)
        self.initial_logits = nn.Parameter(
            safe_log(torch.full((num_states,), 1.0 / num_states)).to(device))

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> torch.Tensor:
        if self.learnable_transitions:
            return torch.softmax(self.transition_logits, dim=-1)
        return self.transition_matrix

    def get_initial_probabilities(self) -> torch.Tensor:
        return torch.softmax(self.initial_logits, dim=-1)

    def _log_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.learnable_transitions:
            log_a = torch.log_softmax(self.transition_logits, dim=-1)
        else:
            log_a = safe_log(self.transition_matrix)
        return log_a, torch.log_softmax(self.initial_logits, dim=-1)

    # -- inference --------------------------------------------------------------
    def _prep(self, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
        if self.apply_sigmoid:
            x = torch.sigmoid(x)
        batched = x.ndim == 3
        if not batched:
            x = x[None]
        if x.shape[-1] != self.num_states:
            raise ValueError(
                f"Input feature dim {x.shape[-1]} must match num_states {self.num_states}"
            )
        return safe_log(x), batched

    def forward(
        self, x: torch.Tensor, return_alignment: bool = False
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Posteriors ``(B, T, K)``; in eval mode with Viterbi inference
        one-hot alignments, and with ``return_alignment`` the states
        ``(B, T)`` too."""
        log_obs, batched = self._prep(x)
        log_a, log_pi = self._log_params()
        if self.training or not self.viterbi_inference:
            log_gamma, *_ = auto_forward_backward(log_obs, log_a, log_pi)
            posteriors = torch.exp(log_gamma)
            return posteriors if batched else posteriors[0]
        with torch.no_grad():
            states, _ = auto_viterbi(log_obs, log_a, log_pi)
        posteriors = nn.functional.one_hot(states.long(), self.num_states).to(log_obs.dtype)
        if not batched:
            posteriors, states = posteriors[0], states[0]
        if return_alignment:
            return posteriors, states
        return posteriors

    def compute_loss(
        self,
        observations: torch.Tensor,
        target_alignment: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Supervised cross-entropy of the log-posteriors at
        ``target_alignment`` (integer states), or the unsupervised
        negative mean log-likelihood."""
        log_obs, _ = self._prep(observations)
        log_a, log_pi = self._log_params()
        if target_alignment is not None:
            log_gamma, *_ = auto_forward_backward(log_obs, log_a, log_pi)
            tgt = torch.as_tensor(target_alignment, device=log_gamma.device).reshape(-1).long()
            lg = log_gamma.reshape(-1, self.num_states)
            return -torch.mean(lg.gather(1, tgt[:, None]))
        return -torch.mean(auto_log_likelihood(log_obs, log_a, log_pi))

    @torch.no_grad()
    def align(self, observations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hard Viterbi alignment and its score in either mode."""
        log_obs, batched = self._prep(observations)
        log_a, log_pi = self._log_params()
        states, score = auto_viterbi(log_obs, log_a, log_pi)
        if not batched:
            return states[0], score[0]
        return states, score

    @torch.no_grad()
    def sample(self, seq_length: int, batch_size: int = 1,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-hot observations and state paths from the layer's chain."""
        log_a, log_pi = self._log_params()
        return core.sample_one_hot(generator, log_a, log_pi, seq_length, batch_size)


class GaussianHMMLayer(nn.Module):
    """HMM with learnable per-state Gaussian emissions over continuous
    features ``(B, T, D)``. ``log_scales`` are log standard deviations:
    ``(K, D)`` for diag, ``(K, 1)`` for spherical; for full covariance
    ``(K, D, D)`` raw Cholesky parameters (strict lower triangle, log of
    the diagonal; zeros, the identity, at first). Means are drawn from
    ``generator`` (a CPU generator, one seeded with 0 when omitted);
    weights are carried from the JAX layer with
    ``bridge.gaussian_hmm_layer_state_dict`` where the two must agree."""

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        covariance_type: str = "diag",
        learnable_transitions: bool = True,
        transition_type: str = "left_to_right",
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        shapes = {"diag": (num_states, feature_dim), "spherical": (num_states, 1),
                  "full": (num_states, feature_dim, feature_dim)}
        if covariance_type not in shapes:
            raise ValueError(f"Unknown covariance_type: {covariance_type}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.covariance_type = covariance_type
        self.hmm_layer = HMMLayer(
            num_states,
            learnable_transitions=learnable_transitions,
            transition_type=transition_type,
            apply_sigmoid=False,
            device=device,
        )
        self.means = nn.Parameter(
            torch.randn((num_states, feature_dim), generator=generator).to(device))
        self.log_scales = nn.Parameter(torch.zeros(shapes[covariance_type], device=device))

    def _compute_gaussian_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        return gaussian_log_probs(observations, self.means, self.log_scales, self.covariance_type)

    def forward(self, observations: torch.Tensor) -> torch.Tensor:
        """Posteriors ``(B, T, K)`` in training mode (or without Viterbi
        inference), one-hot Viterbi alignments in eval mode."""
        batched = observations.ndim == 3
        obs = observations if batched else observations[None]
        log_a, log_pi = self.hmm_layer._log_params()
        if self.training or not self.hmm_layer.viterbi_inference:
            log_gamma, *_ = auto_forward_backward(
                self._compute_gaussian_log_probs(obs), log_a, log_pi)
            posteriors = torch.exp(log_gamma)
        else:
            with torch.no_grad():
                states, _ = auto_viterbi(self._compute_gaussian_log_probs(obs), log_a, log_pi)
            posteriors = nn.functional.one_hot(states.long(), self.num_states).to(obs.dtype)
        return posteriors if batched else posteriors[0]

    def compute_loss(self, observations: torch.Tensor) -> torch.Tensor:
        """Negative mean log-likelihood. With checkpointing on
        (``precision.set_checkpointing``) the ``(B, T, K)`` emission scores
        are recomputed in the backward pass instead of kept across it."""
        obs = observations if observations.ndim == 3 else observations[None]

        def _score(o, means, log_scales):
            return gaussian_log_probs(o, means, log_scales, self.covariance_type)

        log_obs = maybe_remat(_score)(obs, self.means, self.log_scales)
        log_a, log_pi = self.hmm_layer._log_params()
        return -torch.mean(auto_log_likelihood(log_obs, log_a, log_pi))
