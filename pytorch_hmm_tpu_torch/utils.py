"""Transition-matrix builders.

Port of ``create_transition_matrix`` and ``create_left_to_right_matrix``
from ``pytorch_hmm_tpu/utils.py``, the two that the HMM layers build
their initial topology with; the rest of that toolbox is not ported yet
(ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch

__all__ = ["create_left_to_right_matrix", "create_transition_matrix"]

_EPS = 1e-8


def _normalize_rows(p: torch.Tensor) -> torch.Tensor:
    return p / (torch.sum(p, dim=-1, keepdim=True) + _EPS)


def create_transition_matrix(
    num_states: int,
    transition_type: str = "ergodic",
    self_loop_prob: float = 0.5,
    forward_prob: float = 0.4,
    skip_prob: float = 0.1,
    dtype=torch.float32,
) -> torch.Tensor:
    """Standard speech-HMM transition topologies, rows normalized to 1.

    Types: ``ergodic`` (fully connected, boosted diagonal),
    ``left_to_right`` (Bakis), ``left_to_right_skip``, ``circular``.
    """
    k = num_states
    i = torch.arange(k)[:, None]
    j = torch.arange(k)[None, :]
    eye = (i == j).to(dtype)
    nxt = (j == i + 1).to(dtype)
    skip2 = (j == i + 2).to(dtype)
    last = (i == k - 1).to(dtype)

    if transition_type == "ergodic":
        p = torch.ones((k, k), dtype=dtype) + torch.eye(k, dtype=dtype) * self_loop_prob * k
    elif transition_type == "left_to_right":
        p = (1 - last) * (self_loop_prob * eye + forward_prob * nxt) + last * eye
    elif transition_type == "left_to_right_skip":
        can_skip = (i < k - 2).to(dtype)
        p = (
            (1 - last) * (self_loop_prob * eye + forward_prob * nxt)
            + can_skip * skip_prob * skip2
            + last * eye
        )
    elif transition_type == "circular":
        circ = (j == (i + 1) % k).to(dtype)
        p = self_loop_prob * eye + forward_prob * circ
    else:
        raise ValueError(f"Unknown transition_type: {transition_type}")
    return _normalize_rows(p)


def create_left_to_right_matrix(
    num_states: int, self_loop_prob: float = 0.7, dtype=torch.float32
) -> torch.Tensor:
    """Bakis-model matrix, the common TTS topology."""
    return create_transition_matrix(
        num_states,
        "left_to_right",
        self_loop_prob=self_loop_prob,
        forward_prob=1.0 - self_loop_prob,
        dtype=dtype,
    )
