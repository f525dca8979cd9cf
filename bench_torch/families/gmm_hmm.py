"""GMM-HMM: ``MixtureGaussianHMMLayer`` with diagonal-covariance mixture
emissions and learnable (ergodic) transitions, decoded by Viterbi.

Weights are drawn on the device from the seed: unit-scale means, log
variances and mixture logits near 0, transition logits near a diagonal
of log(99) (a self-loop of 0.9, near the walk's dwell). Features follow
a segment walk: segments of 2..``walk_max_dwell`` frames, each of a
state other than the one before; each frame is drawn from one component
of its state, picked by the mixture weights, around that component's
mean moved by half a unit a feature, with the component's spread.
"""

import math

import torch

from ..reference import gmm_hmm as ref

_SCALES = (("transition_logits", 0.1), ("mixture_weights_logits", 0.1), ("means", 1.0),
           ("cov_params", 0.1))
_SELF_LOOP = math.log(99.0)


def _shapes(cfg):
    S, C, F = cfg["num_states"], cfg["num_components"], cfg["feature_dim"]
    return {"transition_logits": (S, S), "mixture_weights_logits": (S, C), "means": (S, C, F),
            "cov_params": (S, C, F)}


def weights(cfg, gen, device):
    """The model's weights (``MixtureGaussianHMMLayer``'s parameter names;
    ``cov_params`` are the log variances), float32 on ``device``, in one
    draw."""
    shapes = _shapes(cfg)
    sizes = [math.prod(shapes[k]) for k, _ in _SCALES]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    w = {}
    for (k, scale), part in zip(_SCALES, torch.split(flat, sizes)):
        w[k] = (part * scale).reshape(shapes[k])
    S = cfg["num_states"]
    w["transition_logits"] = w["transition_logits"] + _SELF_LOOP * torch.eye(S, device=device)
    return w


def frame_states(cfg, traffic, lens, gen, device):
    from .walks import segments
    return segments(lens, cfg["num_states"], traffic["max_frames"], cfg["walk_max_dwell"], gen,
                    device)


def observations(w, states, gen):
    """``(P, B, T, F)`` features: each frame from one component of its
    state, drawn by the mixture weights."""
    S, C, F = w["means"].shape
    dev = states.device
    moved = w["means"] + 0.5 * torch.randn((S, C, F), generator=gen, device=dev)
    centers = moved.reshape(S * C, F)
    std = torch.exp(0.5 * w["cov_params"]).reshape(S * C, F)
    cum = torch.cumsum(torch.softmax(w["mixture_weights_logits"], dim=-1), dim=-1)   # (S, C)
    u = torch.rand(states.shape, generator=gen, device=dev)
    comp = (u[..., None] > cum[states]).sum(-1).clamp_(max=C - 1)
    idx = states * C + comp
    x = torch.randn((*states.shape, F), generator=gen, device=dev)
    x.mul_(std[idx])
    x.add_(centers[idx])
    return x


def program(cfg, w, device):
    """The port's model carrying the weights ``w``."""
    from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer

    model = MixtureGaussianHMMLayer(cfg["num_states"], cfg["feature_dim"],
                                    num_components=cfg["num_components"],
                                    covariance_type=cfg["covariance_type"],
                                    learnable_transitions=cfg["learnable_transitions"],
                                    device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model


def program_decode(model, obs, lengths):
    """The timed decode: ``(states (B, T), score (B,))`` on the device."""
    return model(obs, lengths=lengths, return_log_probs=True)


def reference_problem(cfg, w, obs, dtype, matmul):
    """``(log_obs, log_a, log_pi)`` of the plain reference."""
    return (ref.log_obs(obs, w, dtype, matmul), ref.log_a(w, dtype),
            ref.log_pi(cfg["num_states"], dtype, obs.device))


def reference_viterbi(problem, lengths, path=True):
    return ref.viterbi(*problem, lengths, path=path)


def reference_path_score(problem, states, lengths):
    return ref.path_score(*problem, states, lengths)


def shapes(cfg, lens):
    """Sizes of one call for the rooflines: ``B``, valid ``frames``,
    features ``D``, emission columns ``N`` (every component of every
    state), states ``K``."""
    S = cfg["num_states"]
    return {"B": len(lens), "frames": int(sum(lens)), "D": cfg["feature_dim"],
            "N": S * cfg["num_components"], "K": S}


def flops_per_frame(cfg, entry):
    """Operations a valid frame needs, as the algorithm counts them (a
    multiply-add is two). Emission: the squared features (F), per
    component the two products over the features (4F), the bias, scale
    and normalizer (3). The mixture reduction: per component the weight's
    add, the max, the exp and the sum (4). Viterbi: per state an add and
    a compare per predecessor (2S)."""
    S, C, F = cfg["num_states"], cfg["num_components"], cfg["feature_dim"]
    if entry == "decode":
        return F + S * C * (4 * F + 3) + 4 * S * C + 2 * S * S
    raise ValueError(f"gmm_hmm has no entry {entry!r}")
