"""Offline decode: the port's Viterbi decode of a padded batch, its state
paths and scores on the host.

The result comes back as an offline job takes it: copied into page-locked
host buffers made in set-up, then the stream is waited on. The window's
kept calls hold their buffers; an evicted one's buffers go back to the
calls (no copy, no allocation inside the window).

Check: a reservoir sample of the window's calls, drawn from the seed, is
held against the plain reference in float64. ``score_err`` is the worst
row's gap between the program's score and the reference's best score,
relative to the best; ``path_gap`` the worst row's shortfall, in nats, of
the program's path scored by the reference below the reference's best
(a tie between paths costs nothing; a wrong state does).
"""

import torch

from .. import harness
from ..reference.tf32 import exact_matmul, tf32_matmul
from .common import worst


class Session(harness.Session):
    def __init__(self, fam, cfg, traffic, seed, device):
        super().__init__(fam, cfg, traffic, seed, device)
        self.decode = lambda obs, lengths: fam.program_decode(self.model, obs, lengths)
        self.kept = []
        self.out, self.spare = None, []

    def warm(self):
        n = self.traffic["warm_calls"]
        if self.device.type == "cuda":
            states, score = self.decode(*self.pool.batch(0))
            self.spare = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                for t in (states, score))
                          for _ in range(self.traffic["check_calls"] + 1)]
            self.out = self.spare.pop()
        for i in range(n):
            self.call(i)
        self.next_call = n

    def call(self, i):
        obs, lengths = self.pool.batch(i)
        with self.span("model"):
            states, score = self.decode(obs, lengths)
        with self.span("to_host"):
            if self.out is None:
                return states.cpu(), score.cpu()
            self.out[0].copy_(states, non_blocking=True)
            self.out[1].copy_(score, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            return self.out

    def keep(self, n, i, result):
        k = self.traffic["check_calls"]
        item = (i % self.pool.size, result)
        if n < k:
            self.kept.append(item)
            freed = self.spare.pop() if self.spare else None
        else:
            j = self.rng.randrange(n + 1)
            if j >= k:
                return
            freed = self.kept[j][1]
            self.kept[j] = item
        if self.out is not None:
            self.out = freed

    def judge(self):
        groups = {}
        for p, result in self.kept:
            groups.setdefault(p, []).append(result)
        errs, gaps = [], []
        for p, results in sorted(groups.items()):
            obs, lengths = self.pool.obs[p], self.pool.lengths[p]
            problem = self.fam.reference_problem(self.cfg, self.w, obs, torch.float64,
                                                 exact_matmul)
            best, _ = self.fam.reference_viterbi(problem, lengths, path=False)
            best = best.cpu()
            for states, score in results:
                scored = self.fam.reference_path_score(problem, states, lengths).cpu()
                gaps.extend((best - scored).tolist())
                errs.extend(((score.double() - best).abs() / best.abs()).tolist())
        return {"score_err": worst(errs), "path_gap": worst(gaps)}


def control(session, matmul=tf32_matmul):
    """Put the plain reference in float32 with TF32 products (or with the
    products ``matmul`` gives) in the program's place."""
    fam, cfg, w = session.fam, session.cfg, session.w

    def decode(obs, lengths):
        problem = fam.reference_problem(cfg, w, obs, torch.float32, matmul)
        score, states = fam.reference_viterbi(problem, lengths, path=True)
        return states, score

    session.decode = decode
