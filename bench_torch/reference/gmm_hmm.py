"""GMM-HMM (diagonal-covariance Gaussian mixture emissions, ergodic
transitions, a uniform prior) decoded by Viterbi, in plain PyTorch.

State s scores frame x by ``log Σ_c w_{s,c} N(x; μ_{s,c},
diag(exp(log_vars_{s,c})))``, ``w_s = softmax(mixture logits_s)``;
transitions are ``log_softmax`` of the transition logits by row; the
prior is uniform. The Viterbi score is the best path's total over each
row's valid frames; padded frames repeat the row's last valid state.

Departures from the reference model's ``mixture_gaussian.py:157-338``
(crlotwhite/pytorch_hmm v0.2.2):

* the quadratic form is expanded into two products over the features,
  computed a block of frames at a time, where the reference broadcasts
  the observations to ``(B, T, S, C, D)``;
* the log transitions are ``log_softmax`` of the logits, where the
  reference takes a clamped log of ``softmax``; the two agree to within
  rounding at these logits;
* ragged batches: frames at or past a row's length are left out of its
  score and repeat its last valid state, where the reference decodes
  every frame.

Run in float64 it is the judge of the port's decode; in float32 with
TF32 products (``tf32.py``) it is the control the judge must refuse.
"""

import math

import torch

from .tf32 import exact_matmul

LEAVES = ("transition_logits", "mixture_weights_logits", "means", "cov_params")
# Frames scored a block at a time: a (rows, S·C) block in float64 stays
# well under a gigabyte at B=4096.
BLOCK_ROWS = 1 << 20


def log_obs(obs, w, dt, matmul=exact_matmul):
    """State scores ``(B, T, S)`` in ``dt``: the log-sum over each state's
    components of the weighted diagonal Gaussians, the features taken
    into ``dt`` a block at a time."""
    means, lv = w["means"].to(dt), w["cov_params"].to(dt)
    S, C, D = means.shape
    log_w = torch.log_softmax(w["mixture_weights_logits"].to(dt), dim=-1)
    inv = torch.exp(-lv).reshape(S * C, D)
    m2 = means.reshape(S * C, D)
    wq, wl = inv.T.contiguous(), (m2 * inv).T.contiguous()
    const = (-0.5 * (D * math.log(2.0 * math.pi) + torch.sum(lv, dim=-1)).reshape(S * C)
             - 0.5 * torch.sum(m2 * m2 * inv, dim=-1))
    B, T, _ = obs.shape
    x = obs.reshape(B * T, D)
    out = torch.empty((B * T, S), dtype=dt, device=obs.device)
    for a in range(0, B * T, BLOCK_ROWS):
        xb = x[a:a + BLOCK_ROWS].to(dt)
        comp = const - 0.5 * matmul(xb * xb, wq) + matmul(xb, wl)       # (rows, S·C)
        out[a:a + BLOCK_ROWS] = torch.logsumexp(comp.reshape(-1, S, C) + log_w, dim=-1)
    return out.reshape(B, T, S)


def log_a(w, dtype):
    return torch.log_softmax(w["transition_logits"].to(dtype), dim=-1)


def log_pi(num_states, dtype, device):
    return torch.full((num_states,), -math.log(num_states), dtype=dtype, device=device)


def viterbi(lo, la, lp, lengths, path=True):
    """Best path score ``(B,)`` and, with ``path``, its frame states ``(B,
    T)`` (int64, on the host; padded frames repeat the last valid state).
    Ties go to the lowest state."""
    B, T, S = lo.shape
    last = lengths.to(lo.device).long() - 1
    delta = lp + lo[:, 0]
    psi = torch.empty((B, T, S), dtype=torch.uint8, device=lo.device) if path else None
    for t in range(1, T):
        best, arg = torch.max(delta[:, :, None] + la[None], dim=1)
        live = (t <= last)[:, None]
        delta = torch.where(live, best + lo[:, t], delta)
        if path:
            psi[:, t] = arg.to(torch.uint8)
    score, cur = torch.max(delta, dim=-1)
    if not path:
        return score, None
    rows = torch.arange(B, device=lo.device)
    states = torch.empty((B, T), dtype=torch.int64, device=lo.device)
    states[:, T - 1] = cur
    for t in range(T - 1, 0, -1):
        cur = torch.where(t <= last, psi[rows, t, cur].long(), cur)
        states[:, t - 1] = cur
    return score, states.cpu()


def path_score(lo, la, lp, states, lengths):
    """Score ``(B,)`` (float64, on the host) of each row's frame states
    over its valid frames; ``-inf`` for a state out of range."""
    B, T, S = lo.shape
    s = states.to(lo.device).long()
    bad = ((s < 0) | (s >= S)).any(dim=1)
    s = s.clamp(0, S - 1)
    step = lo.double().gather(2, s[..., None])[..., 0]
    step[:, 1:] += la.double()[s[:, :-1], s[:, 1:]]
    valid = torch.arange(T, device=lo.device)[None] < lengths.to(lo.device).long()[:, None]
    valid[:, 0] = True
    out = lp.double()[s[:, 0]] + torch.where(valid, step, 0.0).sum(dim=1)
    return torch.where(bad, float("-inf"), out).cpu()
