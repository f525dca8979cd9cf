"""Hidden semi-Markov model (explicit durations, gamma duration scores,
diagonal-Gaussian emissions), in plain PyTorch.

A segment of state s covers d = 1..D frames and scores ``log p_s(d) +
Σ e_t(s)`` over its frames; ``log p_s(d) = (k-1) log d − r d − lgamma(k) +
k log r`` (gamma at integer d, not renormalised), ``k = softplus(shape)``,
``r = softplus(rate)``. Segments follow each other by ``log_softmax`` of
the transition logits with the diagonal masked (no state follows itself);
the first segment starts at frame 0 under a uniform initial distribution,
the last ends at each row's final valid frame. ``e_t(s) = log N(x_t; μ_s,
diag(exp(log_vars_s)))``, the quadratic form expanded into two products.

The recursions keep, per frame, the last D segment starts and the sums of
the last 1..D emissions (each a sum of at most D terms, so float32 stays
sound), on emissions shifted by each frame's largest; the shifts' sum is
added back to log Z.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .tf32 import exact_matmul

LEAVES = ("transition_logits", "observation_means", "observation_log_vars",
          "duration_shape", "duration_rate")
_EPS = 1e-8


def log_obs(obs, w, matmul=exact_matmul):
    """Emission scores ``(B, T, S)`` in the dtype of ``obs``."""
    means, lv = w["observation_means"].to(obs.dtype), w["observation_log_vars"].to(obs.dtype)
    S, D = means.shape
    B, T, _ = obs.shape
    inv = torch.exp(-lv)
    x = obs.reshape(B * T, D)
    quad = (matmul(x * x, inv.T.contiguous()) - 2.0 * matmul(x, (means * inv).T.contiguous())
            + torch.sum(means * means * inv, dim=-1))
    out = -0.5 * (D * math.log(2.0 * math.pi) + torch.sum(lv, dim=-1)) - 0.5 * quad
    return out.reshape(B, T, S)


def log_a(w, dtype):
    logits = w["transition_logits"].to(dtype)
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    return torch.log_softmax(logits.masked_fill(eye, float("-inf")), dim=-1)


def log_pi(num_states, dtype, device):
    return torch.full((num_states,), -math.log(num_states), dtype=dtype, device=device)


def log_dur(w, max_duration, dtype):
    """Gamma duration scores ``(S, D)``."""
    k = F.softplus(w["duration_shape"].to(dtype))[:, None]
    r = F.softplus(w["duration_rate"].to(dtype))[:, None]
    d = torch.arange(1, max_duration + 1, dtype=dtype, device=k.device)[None]
    return (k - 1.0) * torch.log(d + _EPS) - r * d - torch.lgamma(k) + k * torch.log(r + _EPS)


def _valid(lengths, T, device):
    return torch.arange(T, device=device)[None] < lengths.to(device).long()[:, None]


def _scan(lo, la, lp, ld, viterbi):
    """Segment ends ``(B, T, S)``: the best (``viterbi``) or total score of
    the frames up to t with a segment of s ending at t; with ``viterbi``
    also each end's best duration index and each next start's best
    predecessor, ``(B, T, S)`` each."""
    B, T, S = lo.shape
    D = ld.shape[1]
    ldt = ld.T[None]                                               # (1, D, S)
    starts = torch.cat([lp.expand(B, 1, S),
                        torch.full((B, D - 1, S), float("-inf"), dtype=lo.dtype,
                                   device=lo.device)], 1)          # starts at t, t-1, ...
    sums = torch.zeros((B, D, S), dtype=lo.dtype, device=lo.device)
    ends, dstar, phi = [], [], []
    for t in range(T):
        sums = torch.cat([torch.zeros_like(sums[:, :1]), sums[:, :-1]], 1) + lo[:, t, None]
        cand = starts + ldt + sums                                 # (B, D, S)
        nxt = None
        if viterbi:
            end, arg = torch.max(cand, dim=1)
            nxt, pred = torch.max(end[:, :, None] + la[None], dim=1)
            dstar.append(arg)
            phi.append(pred)
        else:
            end = torch.logsumexp(cand, dim=1)
            nxt = torch.logsumexp(end[:, :, None] + la[None], dim=1)
        ends.append(end)
        starts = torch.cat([nxt[:, None], starts[:, :-1]], 1)
    ends = torch.stack(ends, 1)
    if not viterbi:
        return ends, None, None
    return ends, torch.stack(dstar, 1), torch.stack(phi, 1)


def _shifted(lo, lengths):
    valid = _valid(lengths, lo.shape[1], lo.device)
    shift = torch.where(valid, torch.amax(lo, dim=-1), 0.0)        # (B, T)
    return lo - shift[..., None], shift.sum(1)


def _final(ends, lengths):
    idx = (lengths.to(ends.device).long() - 1)[:, None, None].expand(-1, 1, ends.shape[2])
    return ends.gather(1, idx)[:, 0]                               # (B, S)


def log_z(lo, la, lp, ld, lengths):
    """``log Z (B,)``, differentiable."""
    lo_hat, shift = _shifted(lo, lengths)
    ends, _, _ = _scan(lo_hat, la, lp, ld, viterbi=False)
    return torch.logsumexp(_final(ends, lengths), dim=-1) + shift


def viterbi(lo, la, lp, ld, lengths, path=True):
    """Best segmentation score ``(B,)`` and, with ``path``, the frame
    states ``(B, T)`` (int64, on the host; padded frames repeat the last
    valid state)."""
    lo_hat, shift = _shifted(lo, lengths)
    ends, dstar, phi = _scan(lo_hat, la, lp, ld, viterbi=True)
    fin = _final(ends, lengths)
    score, s_last = torch.max(fin, dim=-1)
    score = score + shift
    if not path:
        return score, None
    dstar, phi = dstar.cpu().numpy(), phi.cpu().numpy()
    s_last, lens = s_last.cpu().numpy(), lengths.cpu().numpy()
    B, T, _ = lo.shape
    states = np.empty((B, T), dtype=np.int64)
    for b in range(B):
        t, s = int(lens[b]) - 1, int(s_last[b])
        states[b, t:] = s
        while t >= 0:
            d = int(dstar[b, t, s]) + 1
            states[b, t - d + 1:t + 1] = s
            t -= d
            if t >= 0:
                s = int(phi[b, t, s])
    return score, torch.from_numpy(states)


def path_score(lo, la, lp, ld, states, lengths):
    """Score ``(B,)`` (float64, on the host) of each row's frame states
    over its valid frames, read as segments (runs of one state); ``-inf``
    for a run longer than D or a state out of range."""
    lo, la, lp, ld = (t.detach().double().cpu().numpy() for t in (lo, la, lp, ld))
    states, lens = states.cpu().numpy().astype(np.int64), lengths.cpu().numpy()
    S, D = ld.shape
    out = np.empty(len(lens))
    for b, L in enumerate(lens):
        s = states[b, :L]
        if s.min() < 0 or s.max() >= S:
            out[b] = -np.inf
            continue
        first = np.concatenate([[0], np.flatnonzero(s[1:] != s[:-1]) + 1])
        durs = np.diff(np.concatenate([first, [L]]))
        runs = s[first]
        if durs.max() > D:
            out[b] = -np.inf
            continue
        out[b] = (lp[runs[0]] + lo[b, np.arange(L), s].sum() + ld[runs, durs - 1].sum()
                  + la[runs[:-1], runs[1:]].sum())
    return torch.from_numpy(out)


class Trainer:
    """``-mean log Z`` minimised by Adam (``torch.optim.Adam``'s update with
    its defaults, written out), on leaves named as ``HSMMLayer``'s
    parameters. ``step`` returns the loss before the update;
    ``first_grad`` the first gradient as read back from the first moment
    after one step."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, w, lr, max_duration, dtype, device, matmul=exact_matmul):
        self.lr, self.max_duration, self.dtype, self.matmul = lr, max_duration, dtype, matmul
        self.p = {k: w[k].detach().to(device, dtype).clone().requires_grad_(True) for k in LEAVES}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.g1 = None

    def loss(self, obs, lengths):
        p, dt = self.p, self.dtype
        lo = log_obs(obs.to(dt), p, self.matmul)
        S = lo.shape[-1]
        lz = log_z(lo, log_a(p, dt), log_pi(S, dt, lo.device), log_dur(p, self.max_duration, dt),
                   lengths)
        return -torch.mean(lz)

    def step(self, batch):
        obs, lengths = batch
        loss = self.loss(obs, lengths)
        grads = torch.autograd.grad(loss, list(self.p.values()))
        self.t += 1
        b1, b2 = self.BETAS
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        with torch.no_grad():
            for (k, p), g in zip(self.p.items(), grads):
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = self.v[k].sqrt() / math.sqrt(bc2) + self.EPS
                p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        if self.t == 1:
            self.g1 = {k: m / (1.0 - b1) for k, m in self.m.items()}
        return loss.detach().cpu()

    def first_grad(self):
        return self.g1

    def leaves(self):
        return self.p
