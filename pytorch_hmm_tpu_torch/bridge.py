"""Carry weights between the JAX package and the torch layers.

Torch cannot reproduce the draws of the JAX layers' ``nnx.Rngs``
initialisation, so a model that must agree with its JAX counterpart gets
its weights copied across, and comes back out for comparison after
training. Both directions are plain numpy, keyed by the JAX attribute
names; this module never sees a JAX object. Nested weights are keyed
by their dotted JAX path (``emission_net.layers.0.kernel``): an
``nnx.Linear`` kernel ``(in, out)`` becomes the transposed
``nn.Linear.weight``, an ``nnx.Embed`` table the ``nn.Embedding.weight``,
an ``nnx.LayerNorm`` scale the ``nn.LayerNorm.weight``; the
``nnx.MultiHeadAttention`` kernels ``(in, heads, head_dim)`` and ``(heads,
head_dim, out)`` and biases ``(heads, head_dim)`` become flat
``(heads·head_dim)`` projections. Pass only the ``nnx.Param`` state
(``nnx.state(model, nnx.Param)``): random-number state has no torch
counterpart.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "gaussian_hmm_layer_numpy",
    "gaussian_hmm_layer_state_dict",
    "hmm_layer_numpy",
    "hmm_layer_state_dict",
    "hsmm_layer_numpy",
    "hsmm_layer_state_dict",
    "mixture_gaussian_numpy",
    "mixture_gaussian_state_dict",
    "neural_hmm_numpy",
    "neural_hmm_state_dict",
    "neural_observation_numpy",
    "neural_observation_state_dict",
    "neural_transition_numpy",
    "neural_transition_state_dict",
    "semi_markov_numpy",
    "semi_markov_state_dict",
    "streaming_processor_numpy",
    "streaming_processor_state_dict",
]

_GMM_KEYS = (
    "transition_logits",        # learnable transitions
    "transition_matrix",        # fixed left-to-right buffer
    "mixture_weights_logits",
    "means",
    "cov_params",
)


def mixture_gaussian_state_dict(
    params: Mapping[str, np.ndarray],
) -> dict[str, torch.Tensor]:
    """``MixtureGaussianHMMLayer`` weights, keyed by the JAX attribute
    names, as a state dict for the torch layer's ``load_state_dict``.

    ``params`` holds ``means``, ``cov_params``, ``mixture_weights_logits``
    and exactly one of ``transition_logits`` / ``transition_matrix``.
    """
    unknown = set(params) - set(_GMM_KEYS)
    if unknown:
        raise KeyError(f"not a MixtureGaussianHMMLayer weight: {sorted(unknown)}")
    missing = {"means", "cov_params", "mixture_weights_logits"} - set(params)
    if missing:
        raise KeyError(f"missing MixtureGaussianHMMLayer weights: {sorted(missing)}")
    if ("transition_logits" in params) == ("transition_matrix" in params):
        raise KeyError("need exactly one of transition_logits / transition_matrix")
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in params.items()
    }


def mixture_gaussian_numpy(layer: torch.nn.Module) -> dict[str, np.ndarray]:
    """A ``MixtureGaussianHMMLayer``'s weights as float32 numpy arrays,
    keyed by the JAX attribute names (the inverse of
    :func:`mixture_gaussian_state_dict`)."""
    return {
        k: v.detach().cpu().numpy().astype(np.float32)
        for k, v in layer.state_dict().items() if k in _GMM_KEYS
    }


# Top-level JAX attributes of HMMLayer (transition_matrix is the Buffer
# of fixed transitions) and GaussianHMMLayer.
_HMM_LAYER_ROOTS = ("transition_logits", "transition_matrix", "initial_logits")
_GAUSSIAN_HMM_ROOTS = ("hmm_layer", "means", "log_scales")
# Top-level JAX attributes of HSMMLayer and DurationConstrainedHMM.
_HSMM_ROOTS = (
    "transition_logits", "observation_means", "observation_log_vars",
    "duration_shape", "duration_rate", "duration_lambda", "duration_scale",
    "duration_concentration", "emission_net",
)
# Of SemiMarkovHMM, AdaptiveDurationHSMM and their DurationModel.
_SEMI_MARKOV_ROOTS = (
    "transition_logits", "initial_logits", "observation_means", "observation_logvars",
    "duration_model", "state_embedding", "context_duration_net", "neural_obs_model",
)
# Of NeuralObservationModel, NeuralTransitionModel, NeuralHMM and
# ContextualNeuralHMM.
_NEURAL_OBS_ROOTS = ("state_embedding", "fe1", "fe2", "mean_net", "logvar_net", "weight_net",
                     "ar_net", "output_net")
_NEURAL_TRANSITION_ROOTS = ("network", "rnn", "output_layer", "in_proj", "blocks")
_NEURAL_HMM_ROOTS = ("initial_logits", "transition_matrix", "transition_model",
                     "observation_model", "phoneme_embedding", "prosody_encoder")


def _to_torch(jax_key: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """The torch state-dict key and array of a dotted JAX path's array."""
    parts = [p for p in jax_key.split(".") if p != "layers"]
    leaf = parts[-1]
    if leaf in ("kernel", "embedding", "scale"):
        parts[-1] = "weight"
    if leaf == "kernel":
        if arr.ndim == 3:
            # Attention: (heads, head_dim, out) output, (in, heads,
            # head_dim) query / key / value.
            out = parts[-2] == "out"
            arr = arr.reshape(-1, arr.shape[-1]) if out else arr.reshape(arr.shape[0], -1)
        arr = arr.T
    elif leaf == "bias" and arr.ndim == 2:
        arr = arr.reshape(-1)
    return ".".join(parts), np.ascontiguousarray(arr)


def _to_jax(torch_key: str, arr: np.ndarray, module: torch.nn.Module) -> tuple[str, np.ndarray]:
    """The inverse of :func:`_to_torch`, read off the module tree."""
    from .models.neural import _MultiHeadAttention

    *path, leaf = torch_key.split(".")
    owner, parent, out = module, None, []
    for p in path:
        if isinstance(owner, torch.nn.Sequential):
            out.append("layers")
        out.append(p)
        parent, owner = owner, getattr(owner, p)
    heads = parent.num_heads if isinstance(parent, _MultiHeadAttention) else None
    if leaf == "weight" and isinstance(owner, torch.nn.Linear):
        arr = arr.T
        if heads is not None:
            arr = (arr.reshape(heads, -1, arr.shape[-1]) if path[-1] == "out"
                   else arr.reshape(arr.shape[0], heads, -1))
        leaf = "kernel"
    elif leaf == "bias" and heads is not None and path[-1] != "out":
        arr = arr.reshape(heads, -1)
    elif leaf == "weight" and isinstance(owner, torch.nn.Embedding):
        leaf = "embedding"
    elif leaf == "weight" and isinstance(owner, torch.nn.LayerNorm):
        leaf = "scale"
    return ".".join(out + [leaf]), np.ascontiguousarray(arr)


def _state_dict(params: Mapping[str, np.ndarray], roots, what) -> dict[str, torch.Tensor]:
    unknown = sorted(k for k in params if k.split(".")[0] not in roots)
    if unknown:
        raise KeyError(f"not a {what} weight: {unknown}")
    out = {}
    for k, v in params.items():
        key, arr = _to_torch(k, np.array(v, dtype=np.float32, copy=True))
        out[key] = torch.from_numpy(arr)
    return out


def _numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return dict(_to_jax(k, v.detach().cpu().numpy().astype(np.float32), module)
                for k, v in module.state_dict().items())


def hmm_layer_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``HMMLayer`` weights, keyed by the JAX attribute names
    (``transition_logits`` or, with fixed transitions, the
    ``transition_matrix`` Buffer; ``initial_logits``), as a state dict
    for the torch layer's ``load_state_dict``."""
    return _state_dict(params, _HMM_LAYER_ROOTS, "HMMLayer")


def hmm_layer_numpy(layer: torch.nn.Module) -> dict[str, np.ndarray]:
    """The inverse of :func:`hmm_layer_state_dict`."""
    return _numpy(layer)


def gaussian_hmm_layer_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``GaussianHMMLayer`` weights, keyed by the JAX attribute paths
    (``means``, ``log_scales``, ``hmm_layer.transition_logits`` or the
    ``hmm_layer.transition_matrix`` Buffer, ``hmm_layer.initial_logits``),
    as a state dict for the torch layer's ``load_state_dict``."""
    return _state_dict(params, _GAUSSIAN_HMM_ROOTS, "GaussianHMMLayer")


def gaussian_hmm_layer_numpy(layer: torch.nn.Module) -> dict[str, np.ndarray]:
    """The inverse of :func:`gaussian_hmm_layer_state_dict`."""
    return _numpy(layer)


def hsmm_layer_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``HSMMLayer`` or ``DurationConstrainedHMM`` weights, keyed by the
    JAX attribute paths (duration buffers of a fixed-duration layer
    included), as a state dict for the torch layer's
    ``load_state_dict``."""
    return _state_dict(params, _HSMM_ROOTS, "HSMMLayer / DurationConstrainedHMM")


def hsmm_layer_numpy(layer: torch.nn.Module) -> dict[str, np.ndarray]:
    """An ``HSMMLayer``'s or ``DurationConstrainedHMM``'s weights and
    buffers as float32 numpy arrays keyed by the JAX attribute paths (the
    inverse of :func:`hsmm_layer_state_dict`)."""
    return _numpy(layer)


def semi_markov_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``SemiMarkovHMM`` or ``AdaptiveDurationHSMM`` weights, keyed by the
    JAX attribute paths (``duration_model.alpha_params``,
    ``duration_model.net.layers.0.kernel``, ``neural_obs_model.fe1.kernel``
    of neural emissions, ...), as a state dict for the torch model's
    ``load_state_dict``."""
    return _state_dict(params, _SEMI_MARKOV_ROOTS, "SemiMarkovHMM / AdaptiveDurationHSMM")


def semi_markov_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """A ``SemiMarkovHMM``'s or ``AdaptiveDurationHSMM``'s weights as
    float32 numpy arrays keyed by the JAX attribute paths (the inverse of
    :func:`semi_markov_state_dict`)."""
    return _numpy(model)


_STREAMING_ROOTS = ("transition_logits", "emission_hidden", "emission_out")


def streaming_processor_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``StreamingHMMProcessor`` weights, keyed by the JAX attribute paths
    (``transition_logits``, ``emission_hidden.kernel``,
    ``emission_out.bias``, ...), as a state dict for the torch
    processor's ``load_state_dict``; ``nnx.Linear`` kernels ``(in, out)``
    become ``nn.Linear`` weights ``(out, in)``."""
    return _state_dict(params, _STREAMING_ROOTS, "StreamingHMMProcessor")


def streaming_processor_numpy(proc: torch.nn.Module) -> dict[str, np.ndarray]:
    """A ``StreamingHMMProcessor``'s weights as float32 numpy arrays keyed
    by the JAX attribute paths (the inverse of
    :func:`streaming_processor_state_dict`)."""
    return _numpy(proc)


def neural_hmm_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``NeuralHMM`` or ``ContextualNeuralHMM`` weights, keyed by the JAX
    attribute paths (``transition_matrix``, ``observation_model.fe1.kernel``,
    ``transition_model.blocks.0.attn.query.kernel``,
    ``transition_model.rnn.cell.dense_i.kernel``, ``phoneme_embedding.embedding``,
    ...), as a state dict for the torch model's ``load_state_dict``."""
    return _state_dict(params, _NEURAL_HMM_ROOTS, "NeuralHMM / ContextualNeuralHMM")


def neural_hmm_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """A ``NeuralHMM``'s or ``ContextualNeuralHMM``'s weights as float32
    numpy arrays keyed by the JAX attribute paths (the inverse of
    :func:`neural_hmm_state_dict`)."""
    return _numpy(model)


def neural_observation_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A standalone ``NeuralObservationModel``'s weights (``fe1.kernel``,
    ``state_embedding.embedding``, ``ar_net.cell.dense_h.bias``, ...) as a
    state dict for the torch model's ``load_state_dict``."""
    return _state_dict(params, _NEURAL_OBS_ROOTS, "NeuralObservationModel")


def neural_observation_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The inverse of :func:`neural_observation_state_dict`."""
    return _numpy(model)


def neural_transition_state_dict(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """A standalone ``NeuralTransitionModel``'s weights
    (``network.lin0.kernel``, ``blocks.0.ln1.scale``, ``rnn.cell.dense_i.kernel``,
    ...) as a state dict for the torch model's ``load_state_dict``."""
    return _state_dict(params, _NEURAL_TRANSITION_ROOTS, "NeuralTransitionModel")


def neural_transition_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The inverse of :func:`neural_transition_state_dict`."""
    return _numpy(model)
