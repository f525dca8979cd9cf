"""Carry weights between the JAX package and the torch layers.

Torch cannot reproduce the draws of the JAX layers' ``nnx.Rngs``
initialisation, so a model that must agree with its JAX counterpart gets
its weights copied across, and comes back out for comparison after
training. Both directions are plain numpy, keyed by the JAX attribute
names; this module never sees a JAX object. Nested weights are keyed
by their dotted JAX path (``emission_net.layers.0.kernel``): an
``nnx.Linear`` kernel ``(in, out)`` becomes the transposed
``nn.Linear.weight``, an ``nnx.Embed`` table the ``nn.Embedding.weight``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "hsmm_layer_numpy",
    "hsmm_layer_state_dict",
    "mixture_gaussian_numpy",
    "mixture_gaussian_state_dict",
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


# Top-level JAX attributes of HSMMLayer and DurationConstrainedHMM.
_HSMM_ROOTS = (
    "transition_logits", "observation_means", "observation_log_vars",
    "duration_shape", "duration_rate", "duration_lambda", "duration_scale",
    "duration_concentration", "emission_net",
)
# Of SemiMarkovHMM, AdaptiveDurationHSMM and their DurationModel.
_SEMI_MARKOV_ROOTS = (
    "transition_logits", "initial_logits", "observation_means", "observation_logvars",
    "duration_model", "state_embedding", "context_duration_net",
)


def _torch_key(jax_key: str) -> tuple[str, bool]:
    """The torch state-dict key of a dotted JAX path, and whether the
    array is transposed on the way (``nnx.Linear`` kernels)."""
    parts = [p for p in jax_key.split(".") if p != "layers"]
    leaf = parts[-1]
    if leaf in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts), leaf == "kernel"


def _jax_key(torch_key: str, module: torch.nn.Module) -> tuple[str, bool]:
    """The inverse of :func:`_torch_key`, read off the module tree."""
    *path, leaf = torch_key.split(".")
    owner, out = module, []
    for p in path:
        if isinstance(owner, torch.nn.Sequential):
            out.append("layers")
        out.append(p)
        owner = getattr(owner, p)
    if leaf == "weight" and isinstance(owner, torch.nn.Linear):
        return ".".join(out + ["kernel"]), True
    if leaf == "weight" and isinstance(owner, torch.nn.Embedding):
        return ".".join(out + ["embedding"]), False
    return ".".join(out + [leaf]), False


def _state_dict(params: Mapping[str, np.ndarray], roots, what) -> dict[str, torch.Tensor]:
    unknown = sorted(k for k in params if k.split(".")[0] not in roots)
    if unknown:
        raise KeyError(f"not a {what} weight: {unknown}")
    out = {}
    for k, v in params.items():
        key, transpose = _torch_key(k)
        arr = np.array(v, dtype=np.float32, copy=True)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr.T) if transpose else arr)
    return out


def _numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    out = {}
    for k, v in module.state_dict().items():
        key, transpose = _jax_key(k, module)
        arr = v.detach().cpu().numpy().astype(np.float32)
        out[key] = np.ascontiguousarray(arr.T) if transpose else arr
    return out


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
    ``duration_model.net.layers.0.kernel``, ...), as a state dict for the
    torch model's ``load_state_dict``."""
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
