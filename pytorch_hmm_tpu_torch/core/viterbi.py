"""Viterbi decoding as a plain torch loop (max-product semiring).

Port of ``pytorch_hmm_tpu.core.viterbi.viterbi`` for static ``(K, K)``
and time-varying ``(B, T, K, K)`` transitions. The add order per frame
is the reference's — ``max_k(delta[k] + log_a[k, j]) + log_obs[t, j]``
— so paths and scores are bit-identical to it, ties included (lowest
predecessor index). This is the plain version the CUDA trellis kernels
(``ops.smallk.smallk_viterbi``, ``ops.scan.pallas_viterbi``) are held
against.

Also ported: ``viterbi_associative`` (O(log T) depth, a max-plus prefix
scan) and ``viterbi_blocked`` (time blocks in the batch dimension), both
static-transition only and reached from ``HMM.viterbi_decode(method=)``.
The associative scan combines elements in the order of
``jax.lax.associative_scan``, so its max-plus products round exactly as
the reference's and paths and scores are bit-identical to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .semiring import LOG_ZERO, max_matmul, max_matvec

__all__ = ["viterbi", "viterbi_associative", "viterbi_blocked"]


def viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    return_score: bool = True,
):
    """Most-likely state path.

    Args:
        log_obs: ``(B, T, K)`` per-state observation log-likelihoods.
        log_a: ``(K, K)`` static or ``(B, T, K, K)`` time-varying log
            transitions (entry ``[:, t]`` governs the step into frame
            ``t``; ``[:, 0]`` is ignored).
        log_pi: ``(K,)`` initial log-probabilities.
        lengths: optional ``(B,)`` valid lengths; the path for padded
            frames repeats the row's final valid state.
        return_score: also return the path log-score.

    Returns:
        ``states (B, T) int32`` and, if requested, ``score (B,)`` — the
        log joint probability of the best path.
    """
    B, T, K = log_obs.shape
    tv = log_a.ndim != 2
    if tv and tuple(log_a.shape) != (B, T, K, K):
        raise ValueError(
            f"viterbi takes (K, K) or (B, T, K, K) = {(B, T, K, K)} transitions, "
            f"got {tuple(log_a.shape)}"
        )
    states_k = torch.arange(K, device=log_obs.device)
    delta = log_pi + log_obs[:, 0]
    psis = []
    for t in range(1, T):
        best, psi = max_matvec(delta, log_a[:, t] if tv else log_a)
        best = best + log_obs[:, t]
        if lengths is not None:
            keep = (t < lengths)[:, None]
            best = torch.where(keep, best, delta)
            # Pad frames point at themselves, so the backtrace repeats
            # the last valid state through them.
            psi = torch.where(keep, psi, states_k)
        delta = best
        psis.append(psi)

    score, state = delta.max(dim=-1)
    states = torch.empty((B, T), dtype=torch.int64, device=log_obs.device)
    states[:, T - 1] = state
    for t in range(T - 1, 0, -1):
        state = psis[t - 1].gather(1, state[:, None])[:, 0]
        states[:, t - 1] = state
    states = states.to(torch.int32)
    if return_score:
        return states, score
    return states


def _associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``elems`` over dim 1 with the associative
    ``fn``, combining in the order ``jax.lax.associative_scan`` does:
    pairs first, the half-length scan recursively, then the even
    elements."""
    n = elems.shape[1]
    if n < 2:
        return elems
    reduced = fn(elems[:, 0:n - 1:2], elems[:, 1::2])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(odd[:, :-1], elems[:, 2::2])
    else:
        even = fn(odd, elems[:, 2::2])
    even = torch.cat([elems[:, :1], even], 1)
    out = torch.empty_like(elems)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _tropical_eye(K: int, like: torch.Tensor) -> torch.Tensor:
    eye = torch.full((K, K), LOG_ZERO, dtype=like.dtype, device=like.device)
    return eye.fill_diagonal_(0.0)


def viterbi_associative(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """Parallel-in-time Viterbi: O(log T) depth, no sequential loop.

    Three stages: all-prefix trellis values by a max-plus matrix prefix
    scan; every frame's backpointers at once; the backtrace as a suffix
    composition of the backpointer maps. Static transitions only;
    ``lengths`` freeze padded frames (identity steps), so padding
    repeats each row's last valid state. Returns ``(states (B, T)
    int32, score (B,))``, identical to :func:`viterbi`.
    """
    B, T, K = log_obs.shape
    if log_a.ndim != 2:
        raise ValueError("viterbi_associative requires static (K, K) log_a")
    dev = log_obs.device
    m = log_a[None, None] + log_obs[:, 1:, None, :]                  # (B, T-1, K, K)
    d0 = (log_pi + log_obs[:, 0])[:, None, None, :].expand(B, 1, K, K)
    chain = torch.cat([d0, m], 1)                                    # (B, T, K, K)
    ident = torch.arange(K, dtype=torch.int64, device=dev)[None, None, :]
    if lengths is not None:
        pad = torch.arange(T, device=dev)[None, :] >= torch.as_tensor(lengths, device=dev)[:, None]
        chain = torch.where(pad[:, :, None, None], _tropical_eye(K, log_obs), chain)
    delta = _associative_scan(max_matmul, chain)[:, :, 0, :]        # (B, T, K)

    psi = torch.argmax(delta[:, :-1, :, None] + log_a, dim=2)        # (B, T-1, K)
    psi = torch.cat([ident.expand(B, 1, K), psi], 1)                 # (B, T, K)
    if lengths is not None:
        psi = torch.where(pad[:, :, None], ident, psi)

    # Suffix compositions of the maps into each frame, evaluated at the
    # final argmax (gathers: exact in any order).
    maps = torch.cat([psi[:, 1:], ident.expand(B, 1, K)], 1)
    suffix = torch.flip(_associative_scan(lambda a, b: torch.gather(b, -1, a),
                                          torch.flip(maps, [1])), [1])
    score, last_state = delta[:, -1].max(dim=-1)
    states = torch.gather(suffix, 2, last_state[:, None, None].expand(B, T, 1))[:, :, 0]
    return states.to(torch.int32), score


def viterbi_blocked(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    blocks: int = 8,
    unroll: int = 8,
    lengths: Optional[torch.Tensor] = None,
):
    """Time-block-parallel Viterbi on one device.

    The P = ``blocks`` time blocks run side by side in the batch
    dimension: a per-block max-plus operator fold, a prefix over the P
    blocks, a per-block rescan from each block's entry trellis, all
    backpointers at once, and a per-block backtrace of every exit
    hypothesis, stitched from the last block back. Three chains of
    length T/P replace two of length T. Static transitions only;
    ``lengths`` make padded frames identity steps. Returns ``(states (B,
    T) int32, score (B,))``, identical to :func:`viterbi`. ``unroll`` is
    the JAX package's scan unroll hint for XLA; a torch loop has no such
    hint, so it is accepted and unused.
    """
    B, T, K = log_obs.shape
    if log_a.ndim != 2:
        raise ValueError("viterbi_blocked requires static (K, K) log_a")
    dev = log_obs.device
    P = blocks
    Tb = -(-T // P)
    Tp = Tb * P
    lo = torch.nn.functional.pad(log_obs, (0, 0, 0, Tp - T))
    lo_b = lo.reshape(B, P, Tb, K)
    delta0 = log_pi + log_obs[:, 0]
    g_idx = torch.arange(P, device=dev)[:, None] * Tb + torch.arange(Tb, device=dev)[None, :]
    eff_len = (torch.full((B,), T, dtype=torch.int64, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev).to(torch.int64))
    eye = _tropical_eye(K, log_obs)

    # Phase A: per-block operator fold.
    F = eye.expand(B, P, K, K)
    rank1 = delta0[:, None, None, :].expand(B, P, K, K)
    for u in range(Tb):
        t = g_idx[:, u]                                              # (P,)
        m = log_a[None, None] + lo_b[:, :, u, None, :]
        m = torch.where((t == 0)[None, :, None, None], rank1, m)
        m = torch.where((t[None, :] >= eff_len[:, None])[:, :, None, None], eye, m)
        F = max_matmul(F, m)

    # Prefix over blocks.
    entries = [delta0]
    acc = F[:, 0]
    for blk in range(1, P):
        entries.append(acc[:, 0, :])
        acc = max_matmul(acc, F[:, blk])
    entry = torch.stack(entries, 1)                                  # (B, P, K)
    score, final_state = acc[:, 0, :].max(dim=-1)

    # Phase B: per-block rescan.
    carry = entry
    deltas = []
    for u in range(Tb):
        t = g_idx[:, u]
        lo_t = lo_b[:, :, u]
        stepped = (carry[:, :, :, None] + log_a).amax(dim=2) + lo_t
        first = delta0[:, None, :] + 0.0 * lo_t
        d = torch.where((t == 0)[None, :, None], first, stepped)
        d = torch.where((t[None, :] >= eff_len[:, None])[:, :, None], carry, d)
        carry = d
        deltas.append(d)
    delta_flat = torch.stack(deltas, 2).reshape(B, Tp, K)[:, :T]

    # All backpointers at once, padded frames as identity maps.
    ident = torch.arange(K, dtype=torch.int64, device=dev)[None, None, :]
    psi = torch.argmax(delta_flat[:, :-1, :, None] + log_a, dim=2)   # (B, T-1, K)
    psi = torch.cat([ident.expand(B, 1, K), psi], 1)
    psi = torch.cat([psi, psi[:, -1:].expand(B, Tp - T, K)], 1)
    pad_mask = torch.arange(Tp, device=dev)[None, :] >= eff_len[:, None]
    psi = torch.where(pad_mask[:, :, None], ident, psi)
    psi_b = psi.reshape(B, P, Tb, K)

    # Phase C: per-block backtrace of every exit hypothesis.
    link = ident.expand(B, P, K)
    states_rev = [None] * Tb
    for u in range(Tb - 1, -1, -1):
        states_rev[u] = link
        link = torch.gather(psi_b[:, :, u], 2, link)
    # Stitch the block exit states from the last block back.
    exits = [None] * P
    exits[P - 1] = final_state
    for blk in range(P - 1, 0, -1):
        exits[blk - 1] = torch.gather(link[:, blk], 1, exits[blk][:, None])[:, 0]
    exit_states = torch.stack(exits, 1)                              # (B, P)
    per_frame = torch.stack(states_rev, 1)                           # (B, Tb, P, K)
    states = torch.gather(per_frame, 3, exit_states[:, None, :, None].expand(B, Tb, P, 1))[..., 0]
    states = states.permute(0, 2, 1).reshape(B, Tp)[:, :T]
    return states.to(torch.int32), score
