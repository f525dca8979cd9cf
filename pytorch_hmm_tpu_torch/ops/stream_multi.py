"""Fixed-width beam decode of one chunk for N streams in one launch.

Port of ``pytorch_hmm_tpu/ops/stream_multi.py``. A serving fleet decodes
many sessions at once; each carries its own beam (``(N, W)`` scores and
last states, ``(N, W, H)`` path histories, ``(N,)`` path lengths) and
the chunk's log-obs ``(N, T, S)`` share one transition matrix. On CUDA
tensors :func:`beam_chunk_multi` launches the hand-written kernel in
``csrc/stream_beam.cu`` (one warp per stream, any N); on CPU tensors it
runs :func:`beam_chunk_multi_reference`, the JAX package's XLA scan
(``streaming._beam_scan_raw``) over a stream axis. Both return the raw
carry (scores not renormalized), bit for bit equal, with ``lax.top_k``'s
order (descending, ties to the lower state) and ``jnp.argmax``'s parent
(ties to the lower slot).

``n_valid`` may differ per stream: the port keeps the fleet's PCM skip
counter per stream, so a stream re-armed mid-fleet decodes fewer frames
of its first chunk than the others.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import _build
from .stream import check_index_tensor, index_vector, stream_chunk_supported

__all__ = ["beam_chunk_multi", "beam_chunk_multi_reference", "multi_stream_supported"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("stream_beam", {"beam_chunk_f32": [_P] * 11 + [_I] * 6 + [_P]})


def multi_stream_supported(
    n_streams: int, num_states: int, t: int, beam_width: int, history: int
) -> bool:
    """True when the kernel takes the shape: the JAX kernel's envelope in
    states, frames, beam width and history. The stream count is free
    (one warp each); the JAX package's cap of 16 streams and its VMEM
    budget are TPU limits."""
    return n_streams >= 1 and stream_chunk_supported(num_states, t, beam_width, history)


def _unpack(carry, device):
    scores, states, paths, path_len = carry
    return (scores, states.to(device=device, dtype=torch.int32),
            paths.to(device=device, dtype=torch.int32),
            path_len.to(device=device, dtype=torch.int32))


def beam_chunk_multi_reference(
    log_a: torch.Tensor,
    log_obs: torch.Tensor,
    n_valid: Union[int, torch.Tensor],
    carry,
):
    """Plain version: ``streaming._beam_scan_raw`` over a stream axis.

    Args as :func:`beam_chunk_multi`. Each valid frame rolls every slot's
    history left by one under its parent's and appends the new state, as
    the XLA scan does."""
    N, T, S = log_obs.shape
    dev = log_obs.device
    sc, ls, pt, pl = _unpack(carry, dev)
    W, H = pt.shape[1], pt.shape[2]
    nv = index_vector(n_valid, N, dev)
    ls = ls.long()
    for t in range(T):
        lo_t = log_obs[:, t, None, :]                                     # (N, 1, S)
        first = sc[:, :, None] + lo_t
        cont = (sc[:, :, None] + log_a[ls]) + lo_t
        table = torch.where((pl == 0)[:, None, None], first, cont)        # (N, W, S)
        best, parent = torch.max(table, dim=1)                           # first max
        new_state = torch.sort(best, dim=1, descending=True, stable=True).indices[:, :W]
        top = best.gather(1, new_state)
        par = parent.gather(1, new_state)
        inherited = pt.gather(1, par[:, :, None].expand(N, W, H))
        new_paths = torch.cat([inherited[:, :, 1:], new_state[:, :, None].to(torch.int32)], dim=2)
        valid = t < nv                                                    # (N,)
        sc = torch.where(valid[:, None], top, sc)
        ls = torch.where(valid[:, None], new_state, ls)
        pt = torch.where(valid[:, None, None], new_paths, pt)
        pl = torch.where(valid, torch.clamp(pl + 1, max=H), pl)
    return sc, ls.to(torch.int32), pt, pl


def beam_chunk_multi(
    log_a: torch.Tensor,
    log_obs: torch.Tensor,
    n_valid: Union[int, torch.Tensor],
    carry,
):
    """Beam decode of one chunk for every stream.

    Args: ``log_a (S, S)``, ``log_obs (N, T, S)``, ``n_valid`` (an int, a
    scalar or an ``(N,)`` int tensor: frames ``t >= n_valid[n]`` leave
    stream ``n``'s carry unchanged), ``carry = (scores (N, W), states
    (N, W) int32, paths (N, W, H) int32, path_len (N,) int32)``. Returns
    the new carry; scores are not renormalized.

    CUDA tensors run the kernel (counted in ``beam_chunk_multi.launches``):
    float32 and contiguous log-obs and scores, inside
    :func:`multi_stream_supported`; anything else raises. CPU tensors run
    the plain version.
    """
    if log_obs.device.type == "cpu":
        return beam_chunk_multi_reference(log_a, log_obs, n_valid, carry)
    dev = log_obs.device
    if log_obs.ndim != 3 or tuple(log_a.shape) != (log_obs.shape[2],) * 2:
        raise ValueError(f"beam_chunk_multi: need log_obs (N, T, S) and log_a (S, S), got "
                         f"{tuple(log_obs.shape)} and {tuple(log_a.shape)}")
    N, T, S = log_obs.shape
    scores, states, paths, path_len = _unpack(carry, dev)
    if paths.ndim != 3 or paths.shape[0] != N:
        raise ValueError(f"beam_chunk_multi: paths must be (N={N}, W, H), got {tuple(paths.shape)}")
    W, H = paths.shape[1], paths.shape[2]
    if min(T, W, H) == 0 or not multi_stream_supported(N, S, T, W, H):
        raise ValueError(
            f"beam_chunk_multi takes S <= 128, 1 <= W <= min(8, S), 1 <= T, H <= 1024; "
            f"got S={S}, W={W}, T={T}, H={H}"
        )
    _build.check_tensors("beam_chunk_multi", dev, log_a=log_a, log_obs=log_obs, scores=scores)
    if tuple(scores.shape) != (N, W):
        raise ValueError(f"beam_chunk_multi: scores must be ({N}, {W}), got {tuple(scores.shape)}")
    states, paths, path_len = states.contiguous(), paths.contiguous(), path_len.contiguous()
    check_index_tensor("beam_chunk_multi", "states", states, (N, W), dev)
    check_index_tensor("beam_chunk_multi", "path_len", path_len, (N,), dev)
    nv = index_vector(n_valid, N, dev)

    new_scores = torch.empty((N, W), dtype=torch.float32, device=dev)
    new_states = torch.empty((N, W), dtype=torch.int32, device=dev)
    new_paths = torch.empty((N, W, H), dtype=torch.int32, device=dev)
    new_len = torch.empty((N,), dtype=torch.int32, device=dev)
    _LIB.launch("beam_chunk_f32", "beam_chunk_multi", log_a, log_obs, nv, scores, states, paths,
                path_len, new_scores, new_states, new_paths, new_len, N, T, S, W, H)
    beam_chunk_multi.launches += 1
    return new_scores, new_states, new_paths, new_len


beam_chunk_multi.launches = 0
