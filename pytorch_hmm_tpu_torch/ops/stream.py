"""Frame-greedy streaming chunk decode (the greedy processor's step).

Port of ``pytorch_hmm_tpu/ops/stream.py``. The streaming processor
decodes a chunk of frames greedily from a carried ``(prev, has_prev)``:
each frame takes the best state given the previous frame's choice
(``log_a[prev] + log_obs[t]``), or, before any frame of the stream has
been decoded, ``log_obs[t] - log S``. The chain is serial and each frame
is a handful of tiny operations, so on CUDA tensors
:func:`greedy_chunk` runs the whole chunk in one launch of the
hand-written kernel in ``csrc/stream_greedy.cu``; on CPU tensors it runs
:func:`greedy_chunk_reference`, the JAX package's XLA scan
(``streaming._greedy_step_xla``) as a loop over frames. Both give the
same states, log-scores and carry, bit for bit, ties to the lowest
state.

The fixed-width beam lives in ``ops/stream_multi.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from . import _build

__all__ = [
    "greedy_chunk",
    "greedy_chunk_reference",
    "log_num_states",
    "stream_chunk_supported",
]

# The JAX kernels' envelope (pytorch_hmm_tpu/ops/stream.py:51-68): one
# lane row of states, chunks and histories of at most 1024 frames, a
# beam of at most one sublane tile.
MAX_STATES = 128
MAX_T = 1024
MAX_W = 8
MAX_H = 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Library("stream_greedy", {"greedy_chunk_f32": [_P] * 9 + [_I, _I, _F, _I, _P]})


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_chunk_supported(
    num_states: int, t: int, beam_width: int = 1, history: int = 1
) -> bool:
    """True when a chunk of ``t`` frames over ``num_states`` states (beam
    ``beam_width``, history ``history``) lies inside the kernels'
    envelope; the same predicate as the JAX package's."""
    return (
        num_states <= MAX_STATES
        and _ceil_to(t, 8) <= MAX_T
        and beam_width <= MAX_W
        and beam_width <= num_states
        and history <= MAX_H
    )


def log_num_states(num_states: int) -> float:
    """``log S`` rounded once to float32 on the host: the constant of the
    greedy first frame, passed to the kernel and the plain version alike
    (a device ``logf`` and ``torch.log`` may differ in the last bit). It
    equals the constant XLA folds into the JAX package's jitted step."""
    return float(torch.tensor(math.log(num_states), dtype=torch.float32))


def index_vector(value: Union[int, torch.Tensor], n: int, device) -> torch.Tensor:
    """``value`` (an int, a scalar or an ``(n,)`` tensor) as a contiguous
    int32 ``(n,)`` tensor on ``device``; an int is filled on the device,
    with no copy from the host."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).expand(n).contiguous()
    return torch.full((n,), int(value), dtype=torch.int32, device=device)


def _carry_tensors(carry, device):
    prev, has = carry
    prev = torch.as_tensor(prev, device=device).to(torch.int32).reshape(())
    has = torch.as_tensor(has, device=device).to(torch.bool).reshape(())
    return prev, has


def greedy_chunk_reference(
    log_a: torch.Tensor,
    log_obs: torch.Tensor,
    n_valid: Union[int, torch.Tensor],
    carry,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain version: ``streaming._greedy_step_xla`` as a loop over frames.

    Returns ``((prev, has_prev), states (T,) int32, scores (T,))`` where
    ``scores`` are the frames' log-scores (the JAX step returns their
    exp). Frames ``t >= n_valid`` are decoded from the frozen carry and
    leave it unchanged."""
    T, S = log_obs.shape
    dev = log_obs.device
    prev, has = _carry_tensors(carry, dev)
    prev = prev.long()
    n_valid = torch.as_tensor(n_valid, device=dev)
    log_s = torch.tensor(log_num_states(S), dtype=log_obs.dtype, device=dev)
    states, scores = [], []
    for t in range(T):
        lo_t = log_obs[t]
        scores_t = torch.where(has, log_a[prev] + lo_t, lo_t - log_s)
        s = torch.argmax(scores_t)
        states.append(s)
        scores.append(scores_t[s])
        valid = t < n_valid
        prev = torch.where(valid, s, prev)
        has = has | valid
    return ((prev.to(torch.int32), has), torch.stack(states).to(torch.int32),
            torch.stack(scores))


def check_index_tensor(what: str, name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be contiguous int32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def greedy_chunk(
    log_a: torch.Tensor,
    log_obs: torch.Tensor,
    n_valid: Union[int, torch.Tensor],
    carry,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Greedy decode of one chunk from a carried ``(prev, has_prev)``.

    Args: ``log_a (S, S)``, ``log_obs (T, S)``, ``n_valid`` (frames of
    the chunk that advance the carry; an int or an int tensor on the
    device), ``carry = (prev int32 scalar, has_prev bool scalar)``.
    Returns ``((prev, has_prev), states (T,) int32, scores (T,))``, the
    frames' log-scores.

    CUDA tensors run the kernel (counted in ``greedy_chunk.launches``):
    float32 and contiguous, inside :func:`stream_chunk_supported`;
    anything else raises. CPU tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return greedy_chunk_reference(log_a, log_obs, n_valid, carry)
    dev = log_obs.device
    if log_obs.ndim != 2 or tuple(log_a.shape) != (log_obs.shape[1],) * 2:
        raise ValueError(f"greedy_chunk: need log_obs (T, S) and log_a (S, S), got "
                         f"{tuple(log_obs.shape)} and {tuple(log_a.shape)}")
    T, S = log_obs.shape
    if T == 0 or not stream_chunk_supported(S, T):
        raise ValueError(f"greedy_chunk takes 1 <= T <= {MAX_T} frames and S <= {MAX_STATES} "
                         f"states, got T={T}, S={S}")
    _build.check_tensors("greedy_chunk", dev, log_a=log_a, log_obs=log_obs)
    prev, has = _carry_tensors(carry, dev)
    nv = index_vector(n_valid, 1, dev)

    states = torch.empty((T,), dtype=torch.int32, device=dev)
    scores = torch.empty((T,), dtype=torch.float32, device=dev)
    new_prev = torch.empty((), dtype=torch.int32, device=dev)
    new_has = torch.empty((), dtype=torch.bool, device=dev)
    _LIB.launch("greedy_chunk_f32", "greedy_chunk", log_a, log_obs, nv, prev, has, states, scores,
                new_prev, new_has, T, S, log_num_states(S))
    greedy_chunk.launches += 1
    return (new_prev, new_has), states, scores


greedy_chunk.launches = 0
