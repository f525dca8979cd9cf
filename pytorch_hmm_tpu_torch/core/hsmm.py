"""Explicit-duration (semi-Markov) segment DP as plain torch code.

Port of ``pytorch_hmm_tpu/core/hsmm.py``: one recursion over time with
O(D·S + S²) work per frame, for the ``max`` semiring (Viterbi
segmentation with backpointers) and the ``sum`` semiring (forward,
backward, likelihood and posteriors).

* segment emission sums are differences of running sums,
  ``E(s, t-d+1..t) = C(s, t) − C(s, t-d)``;
* the predecessor reduction ``μ(t, s) = op_{s'}(score(t, s') +
  log_a[s', s])`` is taken once per frame and read by later frames;
* a ``(D, S)`` ring holds the last D values of μ and C.

These functions are the plain versions of the CUDA kernels in
``ops/hsmm_smallk.py``. :func:`hsmm_viterbi` keeps the JAX scan's
operand grouping ``(log_dur + (C(t) − C(t-d))) + μ(t-d)`` and its
lowest-index tie-breaks, so its paths and scores are bit-identical to
the JAX ``core.hsmm_viterbi`` on the CPU. HSMM semantics: no
self-transitions between segments, durations ``1..D`` from an ``(S, D)``
log-pmf whose entries below ``min_duration`` are ``-inf``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .semiring import LOG_ZERO, logsumexp

__all__ = [
    "hsmm_forward",
    "hsmm_backward",
    "hsmm_posteriors",
    "hsmm_viterbi",
    "hsmm_log_z",
    "hsmm_grads_from_tables",
    "hsmm_posteriors_from_tables",
]

_NEG = LOG_ZERO  # finite log(0): keeps gradients NaN-free in the sum path


def _final_gather(table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``table[b, lengths[b] - 1]`` — (B, T, S) → (B, S)."""
    idx = (lengths - 1).long()[:, None, None].expand(table.shape[0], 1, table.shape[2])
    return table.gather(1, idx)[:, 0]


def _as_lengths(lengths, device) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    return torch.as_tensor(lengths).to(device=device, dtype=torch.long)


def _hsmm_scan(log_obs, log_a, log_pi, log_dur, viterbi: bool):
    """Shared segment-DP recursion. Returns ``(score_table, dstar, phi)``,
    each ``(B, T, S)``; ``dstar`` and ``phi`` are None for the sum
    semiring."""
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    dt, dev = log_obs.dtype, log_obs.device
    la = torch.clamp(log_a, min=_NEG)
    ld_t = torch.clamp(log_dur.T, min=_NEG)                      # (D, S)

    # Rings over the last D frames: slot j holds the value at frame
    # t-1-j. mu(-1) = log_pi (a segment starting at frame 0); C(-1) = 0.
    mu_buf = torch.cat([log_pi.to(dt).expand(B, 1, S),
                        torch.full((B, D - 1, S), _NEG, dtype=dt, device=dev)], 1)
    c_buf = torch.zeros((B, D, S), dtype=dt, device=dev)
    c_run = torch.zeros((B, S), dtype=dt, device=dev)
    j_idx = torch.arange(D, device=dev)[None, :, None]

    vals, dstars, phis = [], [], []
    for t in range(T):
        c_t = c_run + log_obs[:, t]                              # C(t) inclusive
        scores = (ld_t[None] + (c_t[:, None, :] - c_buf)) + mu_buf
        scores = torch.where(j_idx <= t, scores, _NEG)           # need t-d >= -1
        if viterbi:
            val, dstar_t = scores.max(dim=1)
            mu_t, phi_t = (val[:, :, None] + la[None]).max(dim=1)
            dstars.append(dstar_t)
            phis.append(phi_t)
        else:
            val = logsumexp(scores, dim=1)
            mu_t = logsumexp(val[:, :, None] + la[None], dim=1)
        vals.append(val)
        mu_buf = torch.cat([mu_t[:, None], mu_buf[:, :-1]], 1)
        c_buf = torch.cat([c_t[:, None], c_buf[:, :-1]], 1)
        c_run = c_t
    if not viterbi:
        return torch.stack(vals, 1), None, None
    return torch.stack(vals, 1), torch.stack(dstars, 1), torch.stack(phis, 1)


def hsmm_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM forward algorithm.

    ``log_obs (B, T, S)``, ``log_a (S, S)`` (diagonal ``-inf``: no
    self-loops between segments), ``log_pi (S,)``, ``log_dur (S, D)``
    (column ``j`` is duration ``j+1``), optional ``lengths (B,)``.
    Returns ``(log_alpha_star (B, T, S), log_z (B,))``:
    ``log_alpha_star[t, s]`` scores the observations up to ``t`` with a
    segment of ``s`` ending exactly at ``t``; ``log_z`` is taken at each
    row's final valid frame. Alpha is causal, so entries past a row's
    end are unspecified and in-range entries exact.
    """
    log_alpha, _, _ = _hsmm_scan(log_obs, log_a, log_pi, log_dur, viterbi=False)
    lengths = _as_lengths(lengths, log_obs.device)
    fin = log_alpha[:, -1] if lengths is None else _final_gather(log_alpha, lengths)
    return log_alpha, logsumexp(fin, dim=-1)


def hsmm_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most-likely segmentation: ``(states (B, T) int32, score (B,))``.

    Ties go to the lowest duration index, then the lowest predecessor.
    With ``lengths (B,)`` each row decodes its valid prefix and padded
    frames repeat the row's final state.
    """
    delta, dstar, phi = _hsmm_scan(log_obs, log_a, log_pi, log_dur, viterbi=True)
    B, T, S = log_obs.shape
    lengths = _as_lengths(lengths, log_obs.device)
    if lengths is None:
        delta_T, dstar_T = delta[:, -1], dstar[:, -1]
    else:
        delta_T, dstar_T = _final_gather(delta, lengths), _final_gather(dstar, lengths)
    score, s = delta_T.max(dim=-1)
    # The state of the segment covering frame t, and the frames of that
    # segment left at and below t.
    left = dstar_T.gather(1, s[:, None])[:, 0] + 1
    states = torch.empty((B, T), dtype=torch.int32, device=log_obs.device)
    for t in range(T - 1, -1, -1):
        states[:, t] = s
        if t == 0:
            break
        left_m1 = left - 1
        switch = left_m1 == 0
        s_prev = phi[:, t - 1].gather(1, s[:, None])[:, 0]
        d_prev = dstar[:, t - 1].gather(1, s_prev[:, None])[:, 0] + 1
        s_new = torch.where(switch, s_prev, s)
        left_new = torch.where(switch, d_prev, left_m1)
        if lengths is not None:
            # Frames at or past each row's length are padding: they
            # emit the carried final state and leave the carry alone.
            pad = t >= lengths
            s_new = torch.where(pad, s, s_new)
            left_new = torch.where(pad, left, left_new)
        s, left = s_new, left_new
    return states, score


def hsmm_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM backward pass: ``(log_beta_star, log_beta_start)``, each
    ``(B, T, S)``.

    * ``log_beta_star[t, s]`` scores the observations after ``t`` given
      a segment of ``s`` ends at ``t`` (0 at each row's final frame):
      ``lse_{s'}(log_a[s, s'] + beta_start(t+1, s'))``;
    * ``log_beta_start[t, s]`` scores the observations from ``t`` on
      given a segment of ``s`` starts at ``t``:
      ``lse_d(log_dur[s, d] + E(s, t..t+d-1) + beta_star(t+d-1, s))``
      over segments that end by the final frame.

    Suffix sums turn the segment scores into single adds through
    ``w(e, s) = beta_star(e, s) − C(e+1, s)``, held in a ``(D, S)``
    ring. With ``lengths`` the padded frames of ``log_obs`` are zeroed
    first, so in-range entries do not depend on the padding; entries
    past a row's end are unspecified.
    """
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    dt, dev = log_obs.dtype, log_obs.device
    la = torch.clamp(log_a, min=_NEG)
    ld_t = torch.clamp(log_dur.T, min=_NEG)
    j_idx = torch.arange(D, device=dev)[None, :, None]
    lengths = _as_lengths(lengths, dev)
    if lengths is None:
        t_fin = torch.full((B,), T - 1, dtype=torch.long, device=dev)
    else:
        t_fin = lengths - 1
        valid = torch.arange(T, device=dev)[None, :, None] < lengths[:, None, None]
        log_obs = torch.where(valid, log_obs, 0.0)

    w_buf = torch.full((B, D, S), _NEG, dtype=dt, device=dev)
    bstart_next = torch.full((B, S), _NEG, dtype=dt, device=dev)
    c_next = torch.zeros((B, S), dtype=dt, device=dev)           # C(T) = 0
    bstars, bstarts = [], []
    for t in range(T - 1, -1, -1):
        c_t = c_next + log_obs[:, t]                             # suffix sum C(t)
        bs_from_next = logsumexp(la[None] + bstart_next[:, None, :], dim=2)
        beta_star_t = torch.where((t == t_fin)[:, None], 0.0, bs_from_next)
        w_buf = torch.cat([(beta_star_t - c_next)[:, None], w_buf[:, :-1]], 1)
        # The segment must end by the final valid frame: j <= t_fin - t.
        scores = torch.where(j_idx <= (t_fin[:, None, None] - t), ld_t[None] + w_buf, _NEG)
        beta_start_t = c_t + logsumexp(scores, dim=1)
        bstars.append(beta_star_t)
        bstarts.append(beta_start_t)
        bstart_next, c_next = beta_start_t, c_t
    return torch.stack(bstars[::-1], 1), torch.stack(bstarts[::-1], 1)


def _entry_scores(log_alpha, log_a, log_pi):
    """``nu(u, s)``, the log-score of a segment of ``s`` starting at
    frame ``u``: ``lse_{s'}(alpha*(u-1, s') + log_a[s', s])``, with
    ``nu(0) = log_pi``. Shape (B, T, S)."""
    B, _, S = log_alpha.shape
    la = torch.clamp(log_a, min=_NEG)
    mu = logsumexp(log_alpha[:, :-1, :, None] + la[None, None], dim=2)
    return torch.cat([log_pi.to(log_alpha.dtype).expand(B, 1, S), mu], 1)


def _occupancy(seg_start, seg_end):
    """Frame occupancy by the start/end telescoping identity
    ``gamma(t) = Σ_{u<=t} start(u) − Σ_{u<=t-1} end(u)``, clipped to
    [0, 1]."""
    ends = torch.cumsum(seg_end, dim=1)
    gamma = torch.cumsum(seg_start, dim=1) - torch.cat(
        [torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    return torch.clamp(gamma, 0.0, 1.0)


def hsmm_grads_from_tables(log_obs, log_a, log_pi, log_dur, log_alpha,
                           log_bstar, log_bstart, log_z, lengths, g):
    """Closed-form cotangents of ``Σ_b g_b · log Z_b`` with respect to
    ``(log_obs, log_a, log_pi, log_dur)``, the HSMM posterior
    expectations: frame occupancy, segment-transition counts, the first
    segment's state posterior and per-duration segment counts. Table
    algebra over alpha/beta tables from any backend.

    The segment emission sums of the duration counts are built up one
    duration at a time, ``E_d(u) = E_{d-1}(u) + log_obs(u+d-1)``, rather
    than as differences of running sums over the whole row: the same
    sums, without the cancellation of two ~1e5 terms in f32 at speech
    widths.
    """
    B, T, S = log_obs.shape
    D = log_dur.shape[-1]
    dev = log_obs.device
    la = torch.clamp(log_a, min=_NEG)
    ld = torch.clamp(log_dur, min=_NEG)
    lz = log_z[:, None, None]
    gb = g[:, None, None]
    lengths = _as_lengths(lengths, dev)
    valid = None if lengths is None else (
        torch.arange(T, device=dev)[None, :, None] < lengths[:, None, None])

    nu = _entry_scores(log_alpha, log_a, log_pi)
    seg_end = torch.exp(log_alpha + log_bstar - lz)
    seg_start = torch.exp(nu + log_bstart - lz)
    if valid is not None:
        seg_end = torch.where(valid, seg_end, 0.0)
        seg_start = torch.where(valid, seg_start, 0.0)
    gamma = _occupancy(seg_start, seg_end)
    if valid is not None:
        gamma = torch.where(valid, gamma, 0.0)
    d_log_obs = gb * gamma

    d_log_pi = torch.sum(g[:, None] * torch.exp(log_pi[None] + log_bstart[:, 0] - log_z[:, None]), 0)

    # Expected transitions i→j: a segment of i ends at t, one of j
    # starts at t+1 inside the row.
    lxi = log_alpha[:, :-1, :, None] + la[None, None] + log_bstart[:, 1:, None, :] - lz[..., None]
    if lengths is not None:
        tmask = (torch.arange(1, T, device=dev)[None, :] < lengths[:, None])[..., None, None]
        lxi = torch.where(tmask, lxi, float("-inf"))
    d_log_a = torch.sum(gb[..., None] * torch.exp(lxi), dim=(0, 1))

    # Expected segments of state s with duration d: start u, end
    # u+d-1 <= the row's final frame.
    t_fin = (torch.full((B, 1, 1), T - 1, device=dev) if lengths is None
             else (lengths - 1)[:, None, None])
    u_iota = torch.arange(T, device=dev)[None, :, None]
    cols = []
    window = torch.zeros_like(log_obs)
    for d in range(1, D + 1):
        n_u = T - d + 1
        if n_u <= 0:
            cols.append(torch.zeros((S,), dtype=log_obs.dtype, device=dev))
            continue
        window = window[:, :n_u] + log_obs[:, d - 1:]            # E(u..u+d-1)
        expo = nu[:, :n_u] + ld[None, None, :, d - 1] + window + log_bstar[:, d - 1:] - lz
        expo = torch.where(u_iota[:, :n_u] + (d - 1) <= t_fin, expo, float("-inf"))
        cols.append(torch.sum(gb * torch.exp(expo), dim=(0, 1)))
    d_log_dur = torch.stack(cols, 1)
    return d_log_obs, d_log_a, d_log_pi, d_log_dur


class _HSMMLogZ(torch.autograd.Function):
    """``log Z (B,)`` by :func:`hsmm_forward`, ragged when ``lengths`` is
    given, with the closed-form cotangents of
    :func:`hsmm_grads_from_tables` (one backward pass and table algebra,
    no per-frame residuals); gradients at padded frames are zero."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi, log_dur, lengths):
        log_alpha, lz = hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
        ctx.save_for_backward(log_obs, log_a, log_pi, log_dur, lengths, log_alpha, lz)
        return lz

    @staticmethod
    def backward(ctx, g):
        log_obs, log_a, log_pi, log_dur, lengths, log_alpha, lz = ctx.saved_tensors
        bstar, bstart = hsmm_backward(log_obs, log_a, log_dur, lengths)
        grads = hsmm_grads_from_tables(log_obs, log_a, log_pi, log_dur, log_alpha,
                                       bstar, bstart, lz, lengths, g)
        return (*grads, None)


def hsmm_log_z(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Sequence log-likelihood ``(B,)`` over all segmentations,
    differentiable through closed-form posterior-expectation cotangents
    instead of autograd through the forward recursion. The gradients
    double as HSMM E-step statistics (``d/d log_dur`` = expected
    duration counts)."""
    return _HSMMLogZ.apply(log_obs, log_a, log_pi, log_dur,
                           _as_lengths(lengths, log_obs.device))


def hsmm_posteriors(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> dict:
    """Exact HSMM posteriors: ``gamma (B, T, S)`` (frame occupancy, rows
    sum to 1), ``segment_end`` and ``segment_start (B, T, S)``, and
    ``log_z (B,)``. With ``lengths`` all three arrays are zero at padded
    frames."""
    log_alpha, log_z = hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    log_bstar, log_bstart = hsmm_backward(log_obs, log_a, log_dur, lengths)
    return hsmm_posteriors_from_tables(log_a, log_pi, log_alpha, log_bstar,
                                       log_bstart, log_z, lengths)


def hsmm_posteriors_from_tables(log_a, log_pi, log_alpha, log_bstar, log_bstart,
                                log_z, lengths=None) -> dict:
    """:func:`hsmm_posteriors`'s table algebra over alpha/beta tables
    from any backend."""
    lz = log_z[:, None, None]
    seg_end = torch.exp(log_alpha + log_bstar - lz)
    seg_start = torch.exp(_entry_scores(log_alpha, log_a, log_pi) + log_bstart - lz)
    lengths = _as_lengths(lengths, log_alpha.device)
    if lengths is not None:
        valid = torch.arange(log_alpha.shape[1], device=log_alpha.device)[None, :, None] \
            < lengths[:, None, None]
        seg_end = torch.where(valid, seg_end, 0.0)
        seg_start = torch.where(valid, seg_start, 0.0)
    gamma = _occupancy(seg_start, seg_end)
    # The telescoping sum accumulates f32 error over segments;
    # renormalize so gamma is a distribution per frame.
    gamma = gamma / torch.clamp(torch.sum(gamma, dim=-1, keepdim=True), min=1e-30)
    if lengths is not None:
        gamma = torch.where(valid, gamma, 0.0)
    return {"gamma": gamma, "segment_end": seg_end, "segment_start": seg_start, "log_z": log_z}
