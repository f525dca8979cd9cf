"""Contextual neural HMM with self-attention transitions:
``ContextualNeuralHMM(transition_type="transformer")`` with a Gaussian
observation head, trained on ragged batches.

Everything but the transition network is :mod:`.neural_hmm`'s: the
pool, the packed context, the ``Program`` adapter, the emission weights,
the loss. The transition encoder's weights are drawn beside them, in the
same single draw from the seed: each Linear weight N(0, 1/fan_in) and
each bias N(0, 0.01); each LayerNorm's scale 1 + N(0, 0.01) and its
shift N(0, 0.01).
"""

import math

import torch

from ..reference import neural_hmm as nref
from ..reference import neural_hmm_transformer as ref
from . import neural_hmm as nh
from .neural_hmm import frame_states, observations, program, program_loss  # noqa: F401


def _arch(cfg):
    return cfg["num_transformer_layers"], cfg["num_heads"]


def _linears(cfg):
    """``(name, in, out)`` of every Linear of the model."""
    S, D, H, _, L, P = nh._dims(cfg)
    layers, _ = _arch(cfg)
    out = [(nref.PROSODY, P, P), (f"{ref.ENCODER}.in_proj", L + P, H)]
    for i in range(layers):
        attn, ff, _ = ref.block_names(i)
        out += [(name, H, H) for name in (*attn, *ff)]
    return out + [(ref.OUTPUT, H + S, S * S), (nref.TRUNK[0], D, H), (nref.TRUNK[1], H, H),
                  (nref.MEAN, H, D), (nref.LOGVAR, H, D)]


def _draws(cfg):
    """``(name, shape, std, mean)`` of every weight, in the order of the
    draw."""
    S, _, H, V, L, _ = nh._dims(cfg)
    out = [(nref.EMBEDDING, (V, L), 1.0 / math.sqrt(L), 0.0),
           (nref.STATES, (S, H), 1.0 / math.sqrt(H), 0.0), (nref.INITIAL, (S,), 0.1, 0.0),
           ("hmm.transition_matrix", (S, S), 1.0, 0.0)]
    for name, fan_in, fan_out in _linears(cfg):
        out += [(f"{name}.weight", (fan_out, fan_in), 1.0 / math.sqrt(fan_in), 0.0),
                (f"{name}.bias", (fan_out,), 0.1, 0.0)]
    for i in range(_arch(cfg)[0]):
        for name in ref.block_names(i)[2]:
            out += [(f"{name}.weight", (H,), 0.1, 1.0), (f"{name}.bias", (H,), 0.1, 0.0)]
    return out


def weights(cfg, gen, device):
    """The program module's weights by parameter name, float32 on
    ``device``, in one draw."""
    draws = _draws(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in draws]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {name: (part * std + mean).reshape(shape)
            for (name, shape, std, mean), part in zip(draws, torch.split(flat, sizes))}


def reference_trainer(cfg, w, lr, dtype, device, matmul):
    return ref.Trainer(w, lr, cfg["feature_dim"], cfg["prosody_dim"], *_arch(cfg), dtype,
                       device, matmul)


def shapes(cfg, lens):
    """Sizes of one call for the rooflines: :func:`.neural_hmm.shapes`,
    and ``sum_sq`` (Σ L² over the rows), ``layers`` and ``heads``."""
    layers, heads = _arch(cfg)
    return {**nh.shapes(cfg, lens), "sum_sq": int(sum(n * n for n in lens)), "layers": layers,
            "heads": heads}


def products(s, layers):
    """``(in, out, backward products)`` of each product a valid frame runs:
    the prosody projection; the encoder's input projection, each block's
    query, key, value, output and two feed-forward products, and the
    output layer over ``[h, 1/S ...]``; the trunk's two, the head's mean
    and log variance and its three state products (as
    :func:`.neural_hmm.products`). Each runs 2 operations a term forward
    and as many in each backward product (the input's gradient, the
    weight's); the features' and the prosody's input gradients are not
    needed."""
    D, K, H, C, P = s["D"], s["K"], s["H"], s["C"], s["P"]
    return ([(P, P, 1), (C, H, 2)] + [(H, H, 2)] * (6 * layers)
            + [(H + K, K * K, 2), (D, H, 1), (H, H, 2), (H, D, 2), (H, D, 2)]
            + [(D, K, 2)] * 3)


def product_flops(s, layers):
    """Operations a valid frame of the networks' products, forward and
    backward (a multiply-add is two)."""
    return sum(2 * i * o * (1 + n) for i, o, n in products(s, layers))


def attention_flops(s, layers, keys):
    """Operations a valid query of the attention reads over ``keys`` keys:
    a layer's ``q·kᵀ`` and ``w·v`` forward, 2 a feature and key each (4·H·keys),
    and twice that backward (the gradients of ``w``, ``v``, ``q`` and ``k``);
    the softmax's few a logit left out."""
    return layers * 12 * s["H"] * keys


def flops_per_frame(cfg, entry):
    """Operations a valid frame of a training step needs: the products
    (:func:`product_flops`, 8,171,520 at the cell's widths); the attention
    (:func:`attention_flops`) at the configuration's
    ``attention_keys_per_frame``, the traffic's Σ L² / Σ L (700.94 on
    ``train.b512``'s grid: 6,459,832); and the elementwise work that
    :func:`.neural_hmm.flops_per_frame` counts (the head, the
    log-softmax, the chains, ξ and γ)."""
    s = nh.shapes(cfg, [1])
    layers, _ = _arch(cfg)
    rest = nh.flops_per_frame(cfg, entry) - nh.product_flops(s)
    return (product_flops(s, layers) + attention_flops(s, layers, cfg["attention_keys_per_frame"])
            + rest)
