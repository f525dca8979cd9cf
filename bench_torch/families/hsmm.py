"""HSMM: ``HSMMLayer`` with gamma durations and diagonal-Gaussian
emissions.

Weights are drawn on the device from the seed: unit-scale means, log
variances and transition logits near 0, and the duration parameters near
the layer's own start (gamma shape 2, rate 0.2: a mean of 10 frames).
Features follow the model's own segment walk: segments of 2..D frames,
each of a state other than the one before, around the state's mean moved
by half a unit a feature, with the state's spread.
"""

import math

import torch

from ..reference import hsmm as ref

_SCALES = (("transition_logits", 0.1), ("observation_means", 1.0),
           ("observation_log_vars", 0.1), ("duration_shape", 0.1), ("duration_rate", 0.1))
_DURATION_START = {"duration_shape": 2.0, "duration_rate": 0.2}


def _shapes(cfg):
    S, F = cfg["num_states"], cfg["feature_dim"]
    return {"transition_logits": (S, S), "observation_means": (S, F),
            "observation_log_vars": (S, F), "duration_shape": (S,), "duration_rate": (S,)}


def weights(cfg, gen, device):
    """The model's weights (``HSMMLayer``'s parameter names; durations
    before the softplus), float32 on ``device``, in one draw."""
    shapes = _shapes(cfg)
    sizes = [math.prod(shapes[k]) for k, _ in _SCALES]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    w = {}
    for (k, scale), part in zip(_SCALES, torch.split(flat, sizes)):
        w[k] = (part * scale).reshape(shapes[k])
    for k, value in _DURATION_START.items():
        w[k] = w[k] + math.log(math.expm1(value))
    return w


def observations(w, states, gen):
    P, B, T = states.shape
    S, F = w["observation_means"].shape
    dev = states.device
    centers = w["observation_means"] + 0.5 * torch.randn((S, F), generator=gen, device=dev)
    std = torch.exp(0.5 * w["observation_log_vars"])
    noise = torch.randn((P, B, T, F), generator=gen, device=dev)
    return centers[states] + std[states] * noise


def frame_states(cfg, traffic, lens, gen, device):
    from .walks import segments
    return segments(lens, cfg["num_states"], traffic["max_frames"], cfg["max_duration"], gen,
                    device)


def program(cfg, w, device):
    """The port's model carrying the weights ``w``."""
    from pytorch_hmm_tpu_torch import HSMMLayer

    model = HSMMLayer(cfg["num_states"], cfg["feature_dim"],
                      duration_distribution=cfg["duration_distribution"],
                      max_duration=cfg["max_duration"], device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return model


def program_decode(model, obs, lengths):
    """The timed decode: ``(states (B, T), score (B,))`` on the device."""
    return model(obs, lengths)


def program_loss(model, obs, lengths):
    """The timed training step's loss: mean negative log-likelihood."""
    return model.compute_loss(obs, lengths)


def reference_problem(cfg, w, obs, dtype, matmul):
    """``(log_obs, log_a, log_pi, log_dur)`` of the plain reference."""
    lo = ref.log_obs(obs.to(dtype), w, matmul)
    return (lo, ref.log_a(w, dtype), ref.log_pi(cfg["num_states"], dtype, obs.device),
            ref.log_dur(w, cfg["max_duration"], dtype))


def reference_viterbi(problem, lengths, path=True):
    return ref.viterbi(*problem, lengths, path=path)


def reference_path_score(problem, states, lengths):
    return ref.path_score(*problem, states, lengths)


def reference_trainer(cfg, w, lr, dtype, device, matmul):
    return ref.Trainer(w, lr, cfg["max_duration"], dtype, device, matmul)


def shapes(cfg, lens):
    """Sizes of one call for the rooflines: ``B``, valid ``frames``,
    features ``D``, emission columns ``N``, states ``K``, durations
    ``Dmax``."""
    S = cfg["num_states"]
    return {"B": len(lens), "frames": int(sum(lens)), "D": cfg["feature_dim"], "N": S, "K": S,
            "Dmax": cfg["max_duration"]}


def flops_per_frame(cfg, entry):
    """Operations a valid frame needs, as the algorithm counts them (a
    multiply-add is two). Emission: the squared features (F), per state
    the two products over the features (4F), the bias, scale and
    normalizer (3). Segment DP per state: Viterbi 2S + 3D (an add and a
    compare per predecessor; the window sum, duration score and compare
    per duration); each sum chain 3S + 4D. Training adds the backward
    chain, the posterior algebra from the tables (4D + 3S a state) and
    the emission's two weight products (4F a state)."""
    S, F, Dm = cfg["num_states"], cfg["feature_dim"], cfg["max_duration"]
    emission = F + S * (4 * F + 3)
    if entry == "decode":
        return emission + S * (2 * S + 3 * Dm)
    if entry == "train":
        return emission + 2 * S * (3 * S + 4 * Dm) + S * (4 * Dm + 3 * S) + 4 * F * S
    raise ValueError(f"hsmm has no entry {entry!r}")
