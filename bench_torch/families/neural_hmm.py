"""Contextual neural HMM: ``ContextualNeuralHMM`` with an MLP of
time-varying transitions and a Gaussian observation head, trained on
ragged batches.

Weights are drawn on the device from the seed: each Linear weight
N(0, 1/fan_in) and each bias N(0, 0.01); the embeddings N(0, 1/width);
the initial logits N(0, 0.01) and the static matrix, which a context
leaves unread, N(0, 1). Features and context follow a segment walk:
segments of 2..``walk_max_dwell`` frames, each of a state other than the
one before; each segment draws one phoneme id, uniform over the
vocabulary, and one N(0, 1) prosody vector; each frame is drawn as
``NeuralObservationModel.sample`` draws it for the segment's state, its
mean moved by half a unit a feature.

The harness hands a call one tensor and the lengths, so the context
travels packed beside the features (``reference.neural_hmm.unpack``), and
:func:`program` returns a module whose ``compute_loss(obs, lengths)``
splits the pack and calls the port's own entry points.
"""

import math

import torch

from ..reference import neural_hmm as ref


def _dims(cfg):
    return (cfg["num_states"], cfg["feature_dim"], cfg["hidden_dim"], cfg["phoneme_vocab_size"],
            cfg["linguistic_context_dim"], cfg["prosody_dim"])


def _linears(cfg):
    """``(name, in, out)`` of every Linear of the model."""
    S, D, H, _, L, P = _dims(cfg)
    return ((ref.PROSODY, P, P), (ref.MLP[0], L + P + S, H), (ref.MLP[1], H, H),
            (ref.MLP[2], H, S * S), (ref.TRUNK[0], D, H), (ref.TRUNK[1], H, H),
            (ref.MEAN, H, D), (ref.LOGVAR, H, D))


def _draws(cfg):
    """``(name, shape, std)`` of every weight, in the order of the draw."""
    S, _, H, V, L, _ = _dims(cfg)
    out = [(ref.EMBEDDING, (V, L), 1.0 / math.sqrt(L)), (ref.STATES, (S, H), 1.0 / math.sqrt(H)),
           (ref.INITIAL, (S,), 0.1), ("hmm.transition_matrix", (S, S), 1.0)]
    for name, fan_in, fan_out in _linears(cfg):
        out += [(f"{name}.weight", (fan_out, fan_in), 1.0 / math.sqrt(fan_in)),
                (f"{name}.bias", (fan_out,), 0.1)]
    return out


def weights(cfg, gen, device):
    """The program module's weights by parameter name, float32 on
    ``device``, in one draw."""
    draws = _draws(cfg)
    sizes = [math.prod(shape) for _, shape, _ in draws]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {name: (part * std).reshape(shape)
            for (name, shape, std), part in zip(draws, torch.split(flat, sizes))}


def frame_states(cfg, traffic, lens, gen, device):
    from .walks import segments
    return segments(lens, cfg["num_states"], traffic["max_frames"], cfg["walk_max_dwell"], gen,
                    device)


def observations(w, states, gen):
    """``(P, B, T, D + 1 + P)`` packed frames: the features drawn at each
    frame's state, the segment's phoneme id and its prosody."""
    emb = w[ref.STATES]
    S, _ = emb.shape
    V = w[ref.EMBEDDING].shape[0]
    Pd = w[f"{ref.PROSODY}.weight"].shape[0]
    dev = states.device
    mean = emb @ w[f"{ref.MEAN}.weight"].T + w[f"{ref.MEAN}.bias"]               # (S, D)
    std = torch.exp(0.5 * (emb @ w[f"{ref.LOGVAR}.weight"].T + w[f"{ref.LOGVAR}.bias"]))
    moved = mean + 0.5 * torch.randn(mean.shape, generator=gen, device=dev)
    x = torch.randn((*states.shape, mean.shape[1]), generator=gen, device=dev)
    x.mul_(std[states])
    x.add_(moved[states])
    # A segment starts where the state changes: neighbours never share one.
    seg = torch.cumsum(torch.cat([torch.zeros_like(states[..., :1]),
                                  (states[..., 1:] != states[..., :-1]).long()], -1), -1)
    n = int(seg.max()) + 1
    phoneme = torch.randint(0, V, (*states.shape[:-1], n), generator=gen, device=dev)
    prosody = torch.randn((*states.shape[:-1], n, Pd), generator=gen, device=dev)
    ph = phoneme.gather(-1, seg).to(torch.float32)
    pros = prosody.gather(-2, seg[..., None].expand(*seg.shape, Pd))
    return torch.cat([x, ph[..., None], pros], dim=-1)


class Program(torch.nn.Module):
    """The port's ``ContextualNeuralHMM`` (as ``hmm``) behind the harness's
    call: ``compute_loss(obs, lengths)`` of a packed batch."""

    def __init__(self, hmm, feature_dim, prosody_dim):
        super().__init__()
        self.hmm = hmm
        self.dims = (feature_dim, prosody_dim)

    def compute_loss(self, obs, lengths=None):
        mel, phonemes, prosody = ref.unpack(obs, *self.dims)
        return self.hmm.compute_loss(mel, self.hmm.encode_context(phonemes, prosody),
                                     lengths=lengths)


def program(cfg, w, device):
    """The program module carrying the weights ``w``."""
    from pytorch_hmm_tpu_torch import ContextualNeuralHMM

    S, D, H, V, L, P = _dims(cfg)
    hmm = ContextualNeuralHMM(S, D, V, linguistic_context_dim=L, prosody_dim=P, hidden_dim=H,
                              transition_type=cfg["transition_type"],
                              observation_type=cfg["observation_type"], dropout=cfg["dropout"],
                              device=device)
    model = Program(hmm, D, P)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model


def program_loss(model, obs, lengths):
    """The timed training step's loss: mean negative log-likelihood."""
    return model.compute_loss(obs, lengths)


def reference_trainer(cfg, w, lr, dtype, device, matmul):
    return ref.Trainer(w, lr, cfg["feature_dim"], cfg["prosody_dim"], dtype, device, matmul)


def shapes(cfg, lens):
    """Sizes of one call for the rooflines: ``B``, valid ``frames``,
    padded ``rows`` (B·T), features ``D``, states ``K``, hidden width
    ``H``, context width ``C``, prosody width ``P``."""
    return {"B": len(lens), "frames": int(sum(lens)), "rows": len(lens) * max(lens),
            "D": cfg["feature_dim"], "K": cfg["num_states"], "H": cfg["hidden_dim"],
            "C": cfg["linguistic_context_dim"] + cfg["prosody_dim"], "P": cfg["prosody_dim"]}


def products(s):
    """``(in, out, backward products)`` of each product a valid frame runs:
    the prosody projection, the transition MLP's three layers, the trunk's
    two, the head's mean and log variance and its three state products.
    Each runs 2 operations a term forward and as many in each backward
    product (the input's gradient, the weight's); the features' and the
    prosody's input gradients are not needed."""
    D, K, H, C, P = s["D"], s["K"], s["H"], s["C"], s["P"]
    return [(P, P, 1), (C + K, H, 2), (H, H, 2), (H, K * K, 2), (D, H, 1), (H, H, 2),
            (H, D, 2), (H, D, 2), (D, K, 2), (D, K, 2), (D, K, 2)]


def product_flops(s):
    """Operations a valid frame of the networks' products, forward and
    backward (a multiply-add is two)."""
    return sum(2 * i * o * (1 + n) for i, o, n in products(s))


def flops_per_frame(cfg, entry):
    """Operations a valid frame of a training step needs: the products
    (:func:`product_flops`, 1,494,912 at the cell's widths); the head's
    elementwise work (6 a feature and 4 a state forward, three times that
    with the backward); the log-softmax over the S² logits (5 a logit
    forward, 4 backward); the two sum chains (3 a predecessor and state
    each: add, exp, sum); the ξ algebra (6 a transition: three adds, the
    exp, the mask, the cotangent's product) and γ (5 a state)."""
    if entry != "train":
        raise ValueError(f"neural_hmm has no entry {entry!r}")
    s = shapes(cfg, [1])
    D, K = s["D"], s["K"]
    return product_flops(s) + 3 * (6 * D + 4 * K) + 9 * K * K + 6 * K * K + 6 * K * K + 5 * K
