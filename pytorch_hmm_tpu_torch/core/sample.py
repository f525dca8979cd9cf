"""Ancestral sampling from HMM state chains.

Port of ``pytorch_hmm_tpu/core/sample.py``: a loop over time with one
categorical draw per step. Draws come from a ``torch.Generator`` on the
parameters' device where the JAX package takes a PRNG key; the two give
different numbers from the same seed, so the samples agree with the JAX
package in distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_one_hot", "sample_states"]


def sample_states(
    generator: Optional[torch.Generator],
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    seq_length: int,
    batch_size: int = 1,
) -> torch.Tensor:
    """Draw ``(B, T)`` int32 state paths from the Markov chain. Without
    a generator, one on ``log_a``'s device seeded with 0 is used."""
    if generator is None:
        generator = torch.Generator(device=log_a.device).manual_seed(0)
    K = log_a.shape[-1]
    p_a = torch.softmax(log_a, dim=-1)
    p0 = torch.softmax(log_pi, dim=-1).expand(batch_size, K)
    state = torch.multinomial(p0, 1, generator=generator)[:, 0]
    states = [state]
    for _ in range(seq_length - 1):
        state = torch.multinomial(p_a[state], 1, generator=generator)[:, 0]
        states.append(state)
    return torch.stack(states, 1).to(torch.int32)


def sample_one_hot(
    generator: Optional[torch.Generator],
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    seq_length: int,
    batch_size: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """State paths and one-hot observations (the state identity as a
    one-hot vector): ``(observations (B, T, K) float32, states (B, T)
    int32)``."""
    states = sample_states(generator, log_a, log_pi, seq_length, batch_size)
    obs = torch.nn.functional.one_hot(states.long(), log_a.shape[-1]).to(torch.float32)
    return obs, states
