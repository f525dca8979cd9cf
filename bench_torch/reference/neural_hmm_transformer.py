"""Contextual neural HMM whose time-varying transitions come from a
self-attention encoder, trained on ``-mean log Z``, in plain PyTorch.

As :mod:`.neural_hmm` (the context, the Gaussian emissions over a trunk
and a state embedding, the prior, the log-space recursion over each
row's valid frames, all taken from there), with the transition MLP
replaced by the reference model's transformer transitions
(``neural.py:38-62``, crlotwhite/pytorch_hmm v0.2.2, as the JAX package
reads them):

* ``h = W_in c_t + b_in`` (context to the hidden width H);
* ``layers`` pre-norm blocks, each ``h += A(LN_1(h))`` then ``h +=
  W_2 relu(W_1 LN_2(h) + b_1) + b_2`` (the feed-forward width H), with
  ``LN(x) = (x - mean) / sqrt(var + 1e-6) · g + b`` over the features;
* ``A``: ``heads`` heads of ``d = H / heads`` features, ``q = W_q x +
  b_q`` over ``√d``, ``k``, ``v`` likewise unscaled, ``softmax(q kᵀ)``
  over the keys of the row's valid frames (keys at or past the row's
  length are left out), times ``v``, heads concatenated, then ``W_o · +
  b_o``;
* ``[h_t, 1/S ... 1/S]`` through the output layer to S·S logits,
  ``log_softmax`` over the next state, the matrix of frame t-1 governing
  the step into t.

Rows are computed ``BLOCK_ROWS`` at a time, each block cut to its
longest row, and their gradients summed, so that the float64 ``(b,
heads, T, T)`` attention of a block fits beside the freed program. The
Linears' products go through ``matmul`` and the attention's batched
products through :func:`batched` of it (``tf32.py``): in float64 the
judge of the port's training step, in float32 with TF32 products the
control that the judge must refuse.
"""

import math

import torch

from . import neural_hmm as ref
from .tf32 import exact_matmul, round_tf32, tf32_matmul

ENCODER = "hmm.transition_model"
OUTPUT = f"{ENCODER}.output_layer"
# Rows a block: at 64 rows of 1000 frames the float64 graph of a block
# keeps about 12 GB of attention weights (three layers of 8 heads) and
# about 5 GB more for the emissions and the recursion.
BLOCK_ROWS = 64


def block_names(i):
    """``(attention projections, feed-forward, norms)`` of block ``i``."""
    b = f"{ENCODER}.blocks.{i}"
    return (tuple(f"{b}.attn.{n}" for n in ("query", "key", "value", "out")),
            (f"{b}.ff1", f"{b}.ff2"), (f"{b}.ln1", f"{b}.ln2"))


def leaves(layers):
    """The leaves of a model of ``layers`` blocks, named as the
    benchmark's program module names them (the static matrix left out: a
    context is always given, so nothing reads it)."""
    linears = [ref.PROSODY, f"{ENCODER}.in_proj"]
    norms = []
    for i in range(layers):
        attn, ff, ln = block_names(i)
        linears += [*attn, *ff]
        norms += ln
    linears += [OUTPUT, *ref.TRUNK, ref.MEAN, ref.LOGVAR]
    return (ref.EMBEDDING, ref.STATES, ref.INITIAL,
            *(f"{name}.{part}" for name in (*linears, *norms) for part in ("weight", "bias")))


class _TF32BatchedMatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def batched(matmul):
    """``bmm(a (..., m, k), b (..., k, n))`` in the precision of the 2-D
    ``matmul``: the operands' own for :func:`exact_matmul`, TF32 for
    :func:`tf32_matmul`."""
    if matmul is exact_matmul:
        return torch.matmul
    if matmul is tf32_matmul:
        return _TF32BatchedMatMul.apply
    raise ValueError(f"no batched product in the precision of {matmul!r}")


def layer_norm(x, p, name, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}.weight"] + p[f"{name}.bias"]


def attention(x, p, names, heads, keys, matmul=exact_matmul):
    """Self-attention of ``x (B, T, H)`` over the keys ``keys (B, T)``
    (bool, True where read)."""
    B, T, H = x.shape
    d = H // heads
    bmm = batched(matmul)

    def split(name):
        return ref._linear(x, p, name, matmul).reshape(B, T, heads, d).transpose(1, 2)

    q, k, v = split(names[0]) / math.sqrt(d), split(names[1]), split(names[2])
    logits = bmm(q, k.transpose(-1, -2)).masked_fill(~keys[:, None, None, :], float("-inf"))
    out = bmm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(B, T, H)
    return ref._linear(out, p, names[3], matmul)


def log_transitions(p, phonemes, prosody, lengths, layers, heads, matmul=exact_matmul):
    """``(B, T, S, S)`` log transitions, entry ``[:, t]`` governing the
    step into frame t."""
    S = p[ref.STATES].shape[0]
    B, T = phonemes.shape
    ctx = torch.cat([p[ref.EMBEDDING][phonemes], ref._linear(prosody, p, ref.PROSODY, matmul)],
                    dim=-1)
    keys = torch.arange(T, device=ctx.device)[None] < lengths.to(ctx.device).long()[:, None]
    h = ref._linear(ctx, p, f"{ENCODER}.in_proj", matmul)
    for i in range(layers):
        attn, ff, ln = block_names(i)
        h = h + attention(layer_norm(h, p, ln[0]), p, attn, heads, keys, matmul)
        f = torch.relu(ref._linear(layer_norm(h, p, ln[1]), p, ff[0], matmul))
        h = h + ref._linear(f, p, ff[1], matmul)
    h = torch.cat([h, torch.full((B, T, S), 1.0 / S, dtype=h.dtype, device=h.device)], dim=-1)
    logits = ref._linear(h, p, OUTPUT, matmul)
    log_a = torch.log_softmax(logits.reshape(B, T, S, S), dim=-1)
    return torch.cat([log_a[:, :1], log_a[:, :-1]], dim=1)


def row_log_z(p, obs, lengths, feature_dim, prosody_dim, layers, heads, matmul=exact_matmul):
    """``log Z (B,)`` of a packed batch in the leaves' dtype."""
    x, phonemes, prosody = ref.unpack(obs, feature_dim, prosody_dim)
    dt = p[ref.STATES].dtype
    lo = ref.log_obs(p, x.to(dt), matmul)
    la = log_transitions(p, phonemes, prosody.to(dt), lengths, layers, heads, matmul)
    return ref.log_z(lo, la, torch.log_softmax(p[ref.INITIAL], dim=-1), lengths)


class Trainer(ref.Trainer):
    """:class:`.neural_hmm.Trainer` (Adam written out) on this model's
    leaves."""

    def __init__(self, w, lr, feature_dim, prosody_dim, layers, heads, dtype, device,
                 matmul=exact_matmul):
        self.lr, self.dtype, self.matmul = lr, dtype, matmul
        self.dims = (feature_dim, prosody_dim, layers, heads)
        self.p = {k: w[k].detach().to(device, dtype).clone().requires_grad_(True)
                  for k in leaves(layers)}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        self.g1 = None

    def loss_and_grads(self, obs, lengths):
        """The loss and its gradients, summed over blocks of rows, each
        block cut to its longest row."""
        B = obs.shape[0]
        leaves_ = list(self.p.values())
        loss, grads = 0.0, [torch.zeros_like(v) for v in leaves_]
        for a in range(0, B, BLOCK_ROWS):
            ln = lengths[a:a + BLOCK_ROWS]
            T = int(ln.max())
            part = -torch.sum(row_log_z(self.p, obs[a:a + BLOCK_ROWS, :T], ln, *self.dims,
                                        self.matmul)) / B
            # A block of one-frame rows reads no transition.
            for g, d in zip(grads, torch.autograd.grad(part, leaves_, allow_unused=True)):
                if d is not None:
                    g.add_(d)
            loss = loss + part.detach()
        return loss, grads
