"""Neural HMMs: learned transition and observation models.

Port of ``pytorch_hmm_tpu/models/neural.py`` as ``nn.Module``s:
context-dependent transition matrices (MLP, LSTM or self-attention
encoder), neural observation models (gaussian, mixture and
autoregressive heads over a shared trunk and a state embedding), their
combination ``NeuralHMM`` with static or time-varying ``(B, T, S, S)``
transitions, and the phoneme/prosody ``ContextualNeuralHMM``.

On CUDA tensors the eval-mode gaussian head of every state runs the
``ops.emit_mlp.fused_gaussian_emission`` kernel (differentiable through
its autograd Function; the JAX kernel has none); decode runs
``smallk_viterbi``, posteriors ``fbsum_smallk``, the likelihood the D = 1
sum kernels (static transitions) or ``fbsum_smallk`` (time-varying),
each kernel in its time-varying mode where the transitions are.

A ragged call (``lengths`` with padding) runs the per-frame networks on
its valid frames alone, packed into ``(1, N, ·)``, and scatters their
scores back into the padded layout (:meth:`NeuralHMM._pack`). The
self-attention encoder runs padded, its keys masked by ``lengths``
(``ops.attention.masked_attention``: fused on the card, never a
``(B, H, T, T)`` tensor).

Layers keep flax's names and semantics, so ``bridge`` carries the JAX
weights across: ``nnx.Linear`` as ``nn.Linear`` (kernels transposed),
``nnx.LayerNorm`` with epsilon 1e-6, ``nnx.MultiHeadAttention`` as
per-head projections with logits scaled by ``1/√head_dim``,
``nnx.RNN(OptimizedLSTMCell)`` as a scan from a zero carry with a
bias-free input projection and gates i, f, g, o. Weights are drawn as
flax draws them (lecun-normal kernels truncated at 2σ, zero biases,
orthogonal recurrent kernels, embeddings of std ``1/√features``) from a
CPU ``torch.Generator`` and moved to ``device``; dropout masks come from
a generator each dropout module holds.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.semiring import logsumexp
from ..ops import auto_forward_backward, auto_log_likelihood, auto_viterbi
from ..ops.attention import masked_attention
from ..ops.emit_mlp import (
    fused_emission_supported,
    fused_gaussian_emission,
    gaussian_head,
    gaussian_tables,
)
from ..trace import span

__all__ = [
    "NeuralTransitionModel",
    "NeuralObservationModel",
    "NeuralHMM",
    "ContextualNeuralHMM",
]

_MESH_TODO = ("mesh=... is not ported yet: ROADMAP queue 1 item 12 "
              "(parallel/ on torch.distributed)")
# flax's truncated normal: the std of a unit normal cut at ±2.
_TRUNC_STD = 0.87962566103423978

# The packed route's counters (read by tests and ``chip_smoke.py``): the
# calls that ran the networks on the valid frames alone, and the padded
# frames those calls did not run.
pack_calls = 0
pack_rows_skipped = 0


def _default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def _linear(din: int, dout: int, generator: torch.Generator, bias: bool = True,
            orthogonal: bool = False) -> nn.Linear:
    """An ``nn.Linear`` drawn as ``nnx.Linear`` draws it."""
    lin = nn.Linear(din, dout, bias=bias)
    with torch.no_grad():
        if orthogonal:
            nn.init.orthogonal_(lin.weight, generator=generator)
        else:
            std = math.sqrt(1.0 / din) / _TRUNC_STD
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def _unpack(packed: torch.Tensor, index: torch.Tensor, B: int, T: int,
            fill: float) -> torch.Tensor:
    """``packed (1, N, ...)`` scattered back to ``(B, T, ...)`` at the flat
    frames ``index``, ``fill`` in the rest. The DP reads none of those, but
    a fill that is not finite could turn into NaN in a backward."""
    out = packed.new_full((B * T, *packed.shape[2:]), fill)
    return out.index_copy_(0, index, packed[0]).reshape(B, T, *packed.shape[2:])


def _embedding(num: int, features: int, generator: torch.Generator) -> nn.Embedding:
    emb = nn.Embedding(num, features)
    with torch.no_grad():
        nn.init.normal_(emb.weight, std=math.sqrt(1.0 / features), generator=generator)
    return emb


class _Dropout(nn.Module):
    """Inverted dropout (``nnx.Dropout``) in training mode; its masks come
    from a generator it holds, one per device, seeded at construction."""

    def __init__(self, rate: float, seed: int):
        super().__init__()
        self.rate = rate
        self.seed = seed
        self._generators: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        gen = self._generators.get(x.device)
        if gen is None:
            gen = torch.Generator(device=x.device).manual_seed(self.seed)
            self._generators[x.device] = gen
        keep = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class _MLP(nn.Module):
    """Two ReLU hidden layers with dropout, then a linear output."""

    def __init__(self, din, dhid, dout, dropout, generator):
        super().__init__()
        self.lin0 = _linear(din, dhid, generator)
        self.lin1 = _linear(dhid, dhid, generator)
        self.out = _linear(dhid, dout, generator)
        self.drop = _Dropout(dropout, _seed(generator))

    def forward(self, x):
        x = self.drop(torch.relu(self.lin0(x)))
        return self.out(self.drop(torch.relu(self.lin1(x))))


class _MultiHeadAttention(nn.Module):
    """Self-attention as ``nnx.MultiHeadAttention`` computes it: query, key
    and value projections of ``num_heads`` heads of ``d_model //
    num_heads`` features (flax's ``(in, heads, head_dim)`` kernels as
    ``(heads·head_dim, in)`` weights), logits scaled by ``1/√head_dim``,
    softmax over the keys (with ``lengths``, a row's valid keys alone:
    :func:`ops.attention.masked_attention`, fused on the card), and the
    output projection."""

    def __init__(self, d_model: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"Memory dimension ({d_model}) must be divisible by "
                             f"'num_heads' heads ({num_heads}).")
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.query = _linear(d_model, d_model, generator)
        self.key = _linear(d_model, d_model, generator)
        self.value = _linear(d_model, d_model, generator)
        self.out = _linear(d_model, d_model, generator)

    def forward(self, x, lengths=None):
        B, T, _ = x.shape
        H, hd = self.num_heads, self.head_dim
        q = self.query(x).view(B, T, H, hd) / math.sqrt(hd)
        k = self.key(x).view(B, T, H, hd)
        v = self.value(x).view(B, T, H, hd)
        return self.out(masked_attention(q, k, v, lengths).reshape(B, T, H * hd))


class _TransformerBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dropout, generator):
        super().__init__()
        self.attn = _MultiHeadAttention(d_model, n_heads, generator)
        self.ff1 = _linear(d_model, d_ff, generator)
        self.ff2 = _linear(d_ff, d_model, generator)
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.drop = _Dropout(dropout, _seed(generator))

    def forward(self, x, lengths=None):
        x = x + self.drop(self.attn(self.ln1(x), lengths))
        return x + self.drop(self.ff2(torch.relu(self.ff1(self.ln2(x)))))


class _LSTMCell(nn.Module):
    """``nnx.OptimizedLSTMCell``'s weights: a bias-free input projection
    and a recurrent projection with bias, both to the four gates."""

    def __init__(self, din: int, dhid: int, generator: torch.Generator):
        super().__init__()
        self.dense_i = _linear(din, 4 * dhid, generator, bias=False)
        self.dense_h = _linear(dhid, 4 * dhid, generator, orthogonal=True)


class _RNN(nn.Module):
    """``nnx.RNN(OptimizedLSTMCell)``: an LSTM scanned over axis 1 from a
    zero carry, every step's hidden state out ``(B, T, H)``. A plain loop
    of T steps (the JAX package's is an XLA scan)."""

    def __init__(self, din: int, dhid: int, generator: torch.Generator):
        super().__init__()
        self.cell = _LSTMCell(din, dhid, generator)
        self.hidden_dim = dhid

    def forward(self, x):
        B, T, _ = x.shape
        xi = self.cell.dense_i(x)
        h = x.new_zeros((B, self.hidden_dim))
        c = x.new_zeros((B, self.hidden_dim))
        out = []
        for t in range(T):
            i, f, g, o = torch.chunk(xi[:, t] + self.cell.dense_h(h), 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)


class NeuralTransitionModel(nn.Module):
    """Context-dependent transition matrices ``(B, T, S, S)``.
    ``model_type``: ``mlp`` | ``rnn`` (LSTM) | ``transformer``
    (self-attention encoder)."""

    def __init__(
        self,
        num_states: int,
        context_dim: int,
        hidden_dim: int = 256,
        model_type: str = "mlp",
        dropout: float = 0.1,
        num_transformer_layers: int = 3,
        num_heads: int = 8,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        generator = _default_generator(generator)
        self.num_states = num_states
        self.context_dim = context_dim
        self.hidden_dim = hidden_dim
        self.model_type = model_type
        S = num_states
        if model_type == "mlp":
            self.network = _MLP(context_dim + S, hidden_dim, S * S, dropout, generator)
        elif model_type == "rnn":
            self.rnn = _RNN(context_dim, hidden_dim, generator)
            self.output_layer = _linear(hidden_dim + S, S * S, generator)
        elif model_type == "transformer":
            self.in_proj = _linear(context_dim, hidden_dim, generator)
            self.blocks = nn.ModuleList(
                _TransformerBlock(hidden_dim, num_heads, hidden_dim, dropout, generator)
                for _ in range(num_transformer_layers)
            )
            self.output_layer = _linear(hidden_dim + S, S * S, generator)
        else:
            raise ValueError(f"Unknown model_type: {model_type}")
        self.to(device)

    def transition_logits(self, context: torch.Tensor,
                          current_state: Optional[torch.Tensor] = None,
                          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw next-state logits ``(B, T, S, S)``, or ``(B, S, S)`` for a
        single-step ``(B, C)`` context. ``current_state`` ``(B, T, S)`` or
        ``(B, S)`` defaults to uniform. ``lengths (B,)`` masks the
        attention encoder's keys at or past each row's length, so a valid
        frame's logits do not depend on the padding (the padded frames'
        are finite and unread); the MLP and the LSTM do not look ahead, and
        ignore it."""
        single = context.ndim == 2
        if single:
            context = context[:, None]
        B, T, _ = context.shape
        S = self.num_states
        if current_state is None:
            current_state = torch.full((B, T, S), 1.0 / S, dtype=context.dtype,
                                       device=context.device)
        elif current_state.ndim == 2:
            current_state = current_state[:, None]
        if self.model_type == "mlp":
            logits = self.network(torch.cat([context, current_state], -1))
        else:
            if self.model_type == "rnn":
                h = self.rnn(context)
            else:
                with span("models.neural.encoder"):
                    h = self.in_proj(context)
                    for block in self.blocks:
                        h = block(h, lengths)
            logits = self.output_layer(torch.cat([h, current_state], -1))
        logits = logits.reshape(B, T, S, S)
        return logits[:, 0] if single else logits

    def forward(self, context: torch.Tensor,
                current_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Transition probabilities, softmax over the next-state axis."""
        return torch.softmax(self.transition_logits(context, current_state), dim=-1)


class NeuralObservationModel(nn.Module):
    """Neural per-state observation scores: a shared trunk (``fe1``,
    ``fe2``) embeds the observations, a state embedding shifts the trunk
    features, and a head (gaussian, mixture or autoregressive) scores the
    observation under each state."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        hidden_dim: int = 256,
        model_type: str = "gaussian",
        num_components: int = 3,
        dropout: float = 0.1,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        generator = _default_generator(generator)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.hidden_dim = hidden_dim
        self.model_type = model_type
        self.num_components = num_components
        H, D, C = hidden_dim, observation_dim, num_components
        if model_type == "gaussian":
            self.mean_net = _linear(H, D, generator)
            self.logvar_net = _linear(H, D, generator)
        elif model_type == "mixture":
            self.weight_net = _linear(H, C, generator)
            self.mean_net = _linear(H, C * D, generator)
            self.logvar_net = _linear(H, C * D, generator)
        elif model_type == "autoregressive":
            self.ar_net = _RNN(D, H, generator)
            self.output_net = _linear(H, D, generator)
        else:
            raise ValueError(f"Unknown model_type: {model_type}")
        self.state_embedding = _embedding(num_states, H, generator)
        self.fe1 = _linear(D, H, generator)
        self.fe2 = _linear(H, H, generator)
        self.drop = _Dropout(dropout, _seed(generator))
        self.to(device)

    def _trunk(self, observations: torch.Tensor) -> torch.Tensor:
        h = self.drop(torch.relu(self.fe1(observations)))
        return self.drop(torch.relu(self.fe2(h)))

    def _head_log_prob(self, feats: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """Score ``obs (..., D)`` given combined features ``(..., H)``."""
        if self.model_type == "gaussian":
            return self._gaussian(obs, self.mean_net(feats), self.logvar_net(feats))
        C, D = self.num_components, self.observation_dim
        w = torch.log_softmax(self.weight_net(feats), dim=-1)
        mean = self.mean_net(feats).reshape(*feats.shape[:-1], C, D)
        log_var = self.logvar_net(feats).reshape(*feats.shape[:-1], C, D)
        return logsumexp(w + self._gaussian(obs[..., None, :], mean, log_var), dim=-1)

    @staticmethod
    def _gaussian(x, mean, log_var):
        d = x.shape[-1]
        log_norm = -0.5 * (d * math.log(2.0 * math.pi) + torch.sum(log_var, dim=-1))
        mahal = torch.sum((x - mean) ** 2 * torch.exp(-log_var), dim=-1)
        return log_norm - 0.5 * mahal

    def log_probs(self, observations: torch.Tensor,
                  state_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``(B, T, S)`` scores for all states, or ``(B, T)`` for given
        ``state_indices``. In eval mode the gaussian head of every state
        inside the kernel's envelope goes through
        ``fused_gaussian_emission`` (the CUDA kernel on the card, its plain
        version on the CPU); training mode and other shapes run the plain
        products on the tensors' own device."""
        B, T, _ = observations.shape
        if self.model_type == "autoregressive":
            # A state-independent surrogate: the AR head ignores the state.
            pred = self.output_net(self.ar_net(observations))
            score = -torch.mean((pred - observations) ** 2, dim=-1)
            if state_indices is None:
                return score[..., None].expand(B, T, self.num_states)
            return score
        if state_indices is None and self.model_type == "gaussian" and self._use_fused_emission():
            return self._fused_gaussian_log_probs(observations)
        obs_feats = self._trunk(observations)
        if state_indices is None:
            return self._all_state_log_probs(obs_feats, observations)
        return self._head_log_prob(obs_feats + self.state_embedding(state_indices), observations)

    def _use_fused_emission(self) -> bool:
        return not self.training and fused_emission_supported(
            self.observation_dim, self.hidden_dim, self.num_states)

    def _fused_gaussian_log_probs(self, observations: torch.Tensor) -> torch.Tensor:
        """The trunk and head of every state in one kernel
        (``ops.emit_mlp``); the same function as the gaussian branch of
        :meth:`_all_state_log_probs` with dropout off."""
        tables = gaussian_tables(self.state_embedding.weight, self.mean_net.weight.T,
                                 self.logvar_net.weight.T)
        layers = [p for lin in (self.fe1, self.fe2, self.mean_net, self.logvar_net)
                  for p in (lin.weight.T, lin.bias)]
        args = [t.contiguous() for t in (*layers, *tables)]
        return fused_gaussian_emission(observations.to(args[0].dtype).contiguous(), *args)

    def _all_state_log_probs(self, obs_feats: torch.Tensor,
                             observations: torch.Tensor) -> torch.Tensor:
        """``(B, T, S)`` head scores of every state without a ``(B, T, S,
        H)`` feature tensor: the linear heads distribute over ``obs_feats
        + state_emb``, so each state's head output is a shared observation
        part plus a per-state table. The gaussian quadratic runs in the
        centred expanded form (:func:`ops.emit_mlp.gaussian_head`)."""
        x = observations
        emb = self.state_embedding.weight                        # (S, H)
        if self.model_type == "gaussian":
            tables = gaussian_tables(emb, self.mean_net.weight.T, self.logvar_net.weight.T)
            return gaussian_head(x, self.mean_net(obs_feats), self.logvar_net(obs_feats), *tables)
        C, D, S = self.num_components, self.observation_dim, self.num_states
        B, T = x.shape[:2]
        w_log = torch.log_softmax(
            self.weight_net(obs_feats)[:, :, None, :] + (emb @ self.weight_net.weight.T)[None, None],
            dim=-1,
        )                                                        # (B, T, S, C)
        mo = self.mean_net(obs_feats).reshape(B, T, C, D)
        lvo = self.logvar_net(obs_feats).reshape(B, T, C, D)
        ms = (emb @ self.mean_net.weight.T).reshape(S, C, D)
        lvs = (emb @ self.logvar_net.weight.T).reshape(S, C, D)
        u = x[:, :, None, :] - mo                                # (B, T, C, D)
        wo = torch.exp(-lvo)
        ws = torch.exp(-lvs)                                     # (S, C, D)
        mahal = torch.stack(
            [torch.sum((u - ms[s]) ** 2 * wo * ws[s], dim=-1) for s in range(S)], dim=2
        )                                                        # (B, T, S, C)
        log_norm = -0.5 * (
            D * math.log(2.0 * math.pi)
            + torch.sum(lvo, dim=-1)[:, :, None, :]
            + torch.sum(lvs, dim=-1)[None, None]
        )
        return logsumexp(w_log + log_norm - 0.5 * mahal, dim=-1)

    def forward(self, observations: torch.Tensor,
                state_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.log_probs(observations, state_indices)

    def sample(self, state_indices: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Observations ``(..., D)`` for a state sequence, drawn from the
        gaussian head at each state's embedding (gaussian head only); the
        noise comes from ``generator`` (one on the weights' device seeded
        with 0 when omitted)."""
        if self.model_type != "gaussian":
            raise NotImplementedError(
                f"sampling is implemented for the gaussian head only, not {self.model_type!r}"
            )
        emb = self.state_embedding(state_indices)
        mean = self.mean_net(emb)
        std = torch.exp(0.5 * self.logvar_net(emb))
        if generator is None:
            generator = torch.Generator(device=mean.device).manual_seed(0)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        return mean + std * noise


class NeuralHMM(nn.Module):
    """HMM with neural transition and observation models. With
    ``context_dim == 0``, or no context given, the transitions are a
    learnable static matrix."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        context_dim: int = 0,
        hidden_dim: int = 256,
        transition_type: str = "mlp",
        observation_type: str = "gaussian",
        dropout: float = 0.1,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        generator = _default_generator(generator)
        self.num_states = num_states
        self.observation_dim = observation_dim
        self.context_dim = context_dim
        if context_dim > 0:
            self.transition_model = NeuralTransitionModel(
                num_states, context_dim, hidden_dim=hidden_dim, model_type=transition_type,
                dropout=dropout, generator=generator, device=device)
        else:
            self.transition_model = None
        self.transition_matrix = nn.Parameter(
            torch.randn((num_states, num_states), generator=generator).to(device))
        self.observation_model = NeuralObservationModel(
            num_states, observation_dim, hidden_dim=hidden_dim, model_type=observation_type,
            dropout=dropout, generator=generator, device=device)
        self.initial_logits = nn.Parameter(torch.zeros((num_states,), device=device))

    # -- parameter views ------------------------------------------------------
    def _log_transitions(self, context: Optional[torch.Tensor], packed=None,
                         lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Static ``(S, S)`` or time-varying ``(B, T, S, S)`` log
        transitions in the ``core`` convention (entry ``[:, t]`` governs
        the step into frame ``t``); from the packed context of
        :meth:`_pack` where given, ``−log S`` in the padded frames;
        ``lengths`` masks the attention encoder's padded keys."""
        with span("models.neural.transitions"):
            if self.transition_model is not None and context is not None:
                log_a = torch.log_softmax(self.transition_model.transition_logits(
                    context if packed is None else packed[2], lengths=lengths), dim=-1)
                if packed is not None:
                    log_a = _unpack(log_a, packed[0], *context.shape[:2],
                                    -math.log(self.num_states))
                # The matrix computed at frame t-1 governs the step t-1 -> t.
                return torch.cat([log_a[:, :1], log_a[:, :-1]], dim=1)
            return torch.log_softmax(self.transition_matrix, dim=-1)

    def _log_pi(self) -> torch.Tensor:
        return torch.log_softmax(self.initial_logits, dim=-1)

    def _pack(self, observations, context, lengths):
        """The valid frames of a ragged call packed together: ``(index (N,),
        observations (1, N, D), context (1, N, C) or None)``, ``index``
        the flat ``b·T + t`` of each valid frame; None where the call runs
        padded. It packs only where every network the call runs scores a
        frame from that frame alone: the gaussian and mixture heads, and
        the MLP transitions or the static matrix. The LSTM and attention
        transitions and the autoregressive head mix frames along T, so
        they run padded (the attention with its padded keys masked by
        ``lengths``), as do calls without ``lengths`` or without padding.
        N sizes the packed tensors: one sync a call."""
        global pack_calls, pack_rows_skipped
        dynamic = self.transition_model is not None and context is not None
        if (lengths is None or self.observation_model.model_type == "autoregressive"
                or (dynamic and self.transition_model.model_type != "mlp")):
            return None
        B, T = observations.shape[:2]
        with span("models.neural.pack"):
            ln = torch.as_tensor(lengths, device=observations.device)
            valid = torch.arange(T, device=ln.device)[None] < ln[:, None]
            index = torch.nonzero(valid.reshape(-1)).squeeze(1)
            if index.numel() == B * T:
                return None
            obs = observations.reshape(B * T, -1).index_select(0, index)[None]
            ctx = context.reshape(B * T, -1).index_select(0, index)[None] if dynamic else None
        pack_calls += 1
        pack_rows_skipped += B * T - index.numel()
        return index, obs, ctx

    def _dp_args(self, observations, context, mesh, lengths=None):
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        packed = self._pack(observations, context, lengths)
        with span("models.neural.emissions"):
            log_obs = self.observation_model.log_probs(
                observations if packed is None else packed[1])
            if packed is not None:
                log_obs = _unpack(log_obs, packed[0], *observations.shape[:2], 0.0)
        return log_obs, self._log_transitions(context, packed, lengths), self._log_pi()

    # -- inference ------------------------------------------------------------
    # ``lengths (B,)`` (int, valid frames a row) cuts each row's padding
    # out: padding frames are neither scored nor counted, and what a row
    # gives does not depend on them. The gaussian and mixture heads and the
    # MLP transitions run on the valid frames only (:meth:`_pack`); the
    # LSTM and attention transitions and the autoregressive head run over
    # all T frames, the LSTM and the head causal, the attention with the
    # padded keys masked. The matrix at a row's last valid frame governs no
    # step.
    @torch.no_grad()
    def forward(self, observations: torch.Tensor, context: Optional[torch.Tensor] = None,
                mesh=None, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Forward-backward: ``(posteriors, forward, backward)`` in
        probability space. No gradient: train through
        :meth:`compute_loss`. With ``lengths``, a row's frames past its end
        hold no posterior of their own (``core`` repeats the last valid
        frame's; the card's kernel leaves them unspecified)."""
        with span("models.neural.posteriors"):
            log_gamma, log_alpha, log_beta, _ = auto_forward_backward(
                *self._dp_args(observations, context, mesh, lengths), lengths)
            return torch.exp(log_gamma), torch.exp(log_alpha), torch.exp(log_beta)

    @torch.no_grad()
    def viterbi_decode(self, observations: torch.Tensor, context: Optional[torch.Tensor] = None,
                       mesh=None, lengths: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Best path ``(B, T)`` int32 and its score ``(B,)`` under the
        static or time-varying transitions, over each row's ``lengths``
        frames when given."""
        with span("models.neural.decode"):
            return auto_viterbi(*self._dp_args(observations, context, mesh, lengths), lengths)

    def compute_likelihood(self, observations: torch.Tensor,
                           context: Optional[torch.Tensor] = None, mesh=None,
                           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sequence log-likelihood ``(B,)``, differentiable, in log space
        end to end, over each row's ``lengths`` frames when given."""
        with span("models.neural.log_likelihood"):
            return auto_log_likelihood(*self._dp_args(observations, context, mesh, lengths),
                                       lengths)

    def compute_loss(self, observations: torch.Tensor, context: Optional[torch.Tensor] = None,
                     mesh=None, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``-mean(log Z)`` over the rows (each row's ``lengths`` frames
        when given)."""
        with span("models.neural.loss"):
            return -torch.mean(self.compute_likelihood(observations, context, mesh, lengths))


class ContextualNeuralHMM(NeuralHMM):
    """NeuralHMM driven by phoneme and prosody context: a phoneme
    embedding and a prosody projection, concatenated, are the transition
    model's context."""

    def __init__(
        self,
        num_states: int,
        observation_dim: int,
        phoneme_vocab_size: int,
        linguistic_context_dim: int = 64,
        prosody_dim: int = 16,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        **kwargs,
    ):
        generator = _default_generator(generator)
        super().__init__(num_states, observation_dim,
                         context_dim=linguistic_context_dim + prosody_dim,
                         generator=generator, device=device, **kwargs)
        self.phoneme_vocab_size = phoneme_vocab_size
        self.linguistic_context_dim = linguistic_context_dim
        self.prosody_dim = prosody_dim
        self.phoneme_embedding = _embedding(phoneme_vocab_size, linguistic_context_dim,
                                            generator).to(device)
        self.prosody_encoder = _linear(prosody_dim, prosody_dim, generator).to(device)

    def encode_context(self, phoneme_sequence: torch.Tensor,
                       prosody_features: torch.Tensor) -> torch.Tensor:
        """``(B, T)`` phonemes and ``(B, T, P)`` prosody → ``(B, T, C)``
        context."""
        with span("models.neural.context"):
            return torch.cat([self.phoneme_embedding(phoneme_sequence),
                              self.prosody_encoder(prosody_features)], dim=-1)

    def forward_with_context(self, observations: torch.Tensor, phoneme_sequence: torch.Tensor,
                             prosody_features: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None):
        return self(observations, self.encode_context(phoneme_sequence, prosody_features),
                    lengths=lengths)
