"""Contextual neural HMM (phoneme and prosody context, an MLP of
time-varying transitions, a Gaussian observation head over a two-layer
trunk and a state embedding), trained on ``-mean log Z``, in plain
PyTorch.

Frame t of a row carries features x_t (D), a phoneme id and a prosody
vector (P). The context is ``c_t = [E[phoneme_t], W_p p_t + b_p]``. The
transition MLP maps ``[c_t, 1/S ... 1/S]`` through two ReLU layers of H
to S·S logits; ``log_softmax`` over the next state gives the matrix of
frame t, and the matrix of frame t-1 governs the step from t-1 into t.
Each state s scores x_t under a diagonal Gaussian whose mean and log
variance are two linear heads of ``f_t + e_s``: the trunk's features
``f_t = relu(W_2 relu(W_1 x_t + b_1) + b_2)`` plus the state's
embedding. The prior is ``log_softmax`` of the initial logits. ``log Z``
is the log-space forward recursion over each row's valid frames.

Departures from the reference model's ``neural.py:10-588``
(crlotwhite/pytorch_hmm v0.2.2, ``ContextualNeuralHMM`` on
``NeuralHMM``, ``NeuralTransitionModel``, ``NeuralObservationModel``):

* log space throughout: ``log_softmax`` of the logits, where the
  reference forms probabilities with ``softmax`` and takes their log;
* the JAX package's frame convention for the time-varying matrices (the
  matrix computed at frame t-1 governs the step into t; the first
  frame's stands at index 0 and governs nothing);
* dropout 0 (the reference's default is 0.1);
* ragged batches: frames at or past a row's length are left out of its
  ``log Z``, where the reference scores every frame.

The emissions follow the reference's per-state loop (``neural.py:198-208``):
each state's features ``f_t + e_s`` go through both heads, not the
port's centred expansion. Rows are computed ``BLOCK_ROWS`` at a time and
their gradients summed, so a batch of 512 rows of 1000 frames fits in
float64 beside the freed program. Every product goes through ``matmul``
(``tf32.py``). Run in float64 it is the judge of the port's training
step; in float32 with TF32 products it is the control the judge must
refuse.

The benchmark hands each batch over packed, one tensor ``(B, T, D + 1 +
P)``: ``[..., :D]`` the features, ``[..., D]`` the phoneme id as a float
(exact below 2**24), ``[..., D + 1:]`` the prosody; :func:`unpack` splits
it.
"""

import math

import torch

from .tf32 import exact_matmul

# The leaves, named as the benchmark's program module names them (its
# model under ``hmm``). The static ``transition_matrix`` is left out: a
# context is always given, so nothing reads it.
EMBEDDING = "hmm.phoneme_embedding.weight"
PROSODY = "hmm.prosody_encoder"
MLP = ("hmm.transition_model.network.lin0", "hmm.transition_model.network.lin1",
       "hmm.transition_model.network.out")
TRUNK = ("hmm.observation_model.fe1", "hmm.observation_model.fe2")
MEAN, LOGVAR = "hmm.observation_model.mean_net", "hmm.observation_model.logvar_net"
STATES = "hmm.observation_model.state_embedding.weight"
INITIAL = "hmm.initial_logits"
LINEARS = (PROSODY, *MLP, *TRUNK, MEAN, LOGVAR)
LEAVES = (EMBEDDING, STATES, INITIAL,
          *(f"{name}.{part}" for name in LINEARS for part in ("weight", "bias")))
# Rows a block: at 128 rows of 1000 frames the float64 graph of a block
# (12 states' heads, the MLP, 1000 recursion steps) holds about 10 GB.
BLOCK_ROWS = 128


def unpack(obs, feature_dim, prosody_dim):
    """``(features (B, T, D), phonemes (B, T) int64, prosody (B, T, P))``
    of a packed batch, the features and prosody as views."""
    d = feature_dim
    return obs[..., :d], obs[..., d].long(), obs[..., d + 1:d + 1 + prosody_dim]


def _linear(x, p, name, matmul):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    rows = x.reshape(-1, x.shape[-1])
    return (matmul(rows, w.T) + b).reshape(*x.shape[:-1], w.shape[0])


def log_transitions(p, phonemes, prosody, matmul=exact_matmul):
    """``(B, T, S, S)`` log transitions, entry ``[:, t]`` governing the
    step into frame t."""
    S = p[STATES].shape[0]
    ctx = torch.cat([p[EMBEDDING][phonemes], _linear(prosody, p, PROSODY, matmul)], dim=-1)
    h = torch.cat([ctx, torch.full((*ctx.shape[:-1], S), 1.0 / S, dtype=ctx.dtype,
                                   device=ctx.device)], dim=-1)
    for name in MLP[:2]:
        h = torch.relu(_linear(h, p, name, matmul))
    logits = _linear(h, p, MLP[2], matmul)
    log_a = torch.log_softmax(logits.reshape(*logits.shape[:-1], S, S), dim=-1)
    return torch.cat([log_a[:, :1], log_a[:, :-1]], dim=1)


def log_obs(p, x, matmul=exact_matmul):
    """``(B, T, S)`` emission scores: each state's features through both
    heads, one state at a time."""
    f = x
    for name in TRUNK:
        f = torch.relu(_linear(f, p, name, matmul))
    D = x.shape[-1]
    scores = []
    for e in p[STATES]:
        feats = f + e
        mean = _linear(feats, p, MEAN, matmul)
        log_var = _linear(feats, p, LOGVAR, matmul)
        mahal = torch.sum((x - mean) ** 2 * torch.exp(-log_var), dim=-1)
        scores.append(-0.5 * (D * math.log(2.0 * math.pi) + torch.sum(log_var, dim=-1))
                      - 0.5 * mahal)
    return torch.stack(scores, dim=-1)


def log_z(lo, log_a, log_pi, lengths):
    """``(B,)`` log-space forward recursion over each row's valid frames,
    differentiable."""
    lengths = lengths.to(lo.device).long()
    alpha = log_pi + lo[:, 0]
    for t in range(1, int(lengths.max())):
        nxt = torch.logsumexp(alpha[:, :, None] + log_a[:, t], dim=1) + lo[:, t]
        alpha = torch.where((t < lengths)[:, None], nxt, alpha)
    return torch.logsumexp(alpha, dim=-1)


def row_log_z(p, obs, lengths, feature_dim, prosody_dim, matmul=exact_matmul):
    """``log Z (B,)`` of a packed batch in the leaves' dtype."""
    x, phonemes, prosody = unpack(obs, feature_dim, prosody_dim)
    dt = p[STATES].dtype
    lo = log_obs(p, x.to(dt), matmul)
    la = log_transitions(p, phonemes, prosody.to(dt), matmul)
    return log_z(lo, la, torch.log_softmax(p[INITIAL], dim=-1), lengths)


class Trainer:
    """``-mean log Z`` minimised by Adam (``torch.optim.Adam``'s update with
    its defaults, written out), on the leaves :data:`LEAVES`. ``step``
    returns the loss before the update; ``first_grad`` the first gradient
    as read back from the first moment after one step."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, w, lr, feature_dim, prosody_dim, dtype, device, matmul=exact_matmul):
        self.lr, self.dtype, self.matmul = lr, dtype, matmul
        self.dims = (feature_dim, prosody_dim)
        self.p = {k: w[k].detach().to(device, dtype).clone().requires_grad_(True) for k in LEAVES}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.g1 = None

    def loss_and_grads(self, obs, lengths):
        """The loss and its gradients, summed over blocks of rows."""
        B = obs.shape[0]
        leaves = list(self.p.values())
        loss, grads = 0.0, [torch.zeros_like(v) for v in leaves]
        for a in range(0, B, BLOCK_ROWS):
            part = -torch.sum(row_log_z(self.p, obs[a:a + BLOCK_ROWS], lengths[a:a + BLOCK_ROWS],
                                        *self.dims, self.matmul)) / B
            # A block of one-frame rows reads no transition.
            for g, d in zip(grads, torch.autograd.grad(part, leaves, allow_unused=True)):
                if d is not None:
                    g.add_(d)
            loss = loss + part.detach()
        return loss, grads

    def step(self, batch):
        loss, grads = self.loss_and_grads(*batch)
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
        return loss.cpu()

    def first_grad(self):
        return self.g1

    def leaves(self):
        return self.p
