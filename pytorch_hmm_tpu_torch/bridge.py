"""Carry weights between the JAX package and the torch layers.

Torch cannot reproduce the draws of the JAX layers' ``nnx.Rngs``
initialisation, so a model that must agree with its JAX counterpart gets
its weights copied across, and comes back out for comparison after
training. Both directions are plain numpy, keyed by the JAX attribute
names; this module never sees a JAX object.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["mixture_gaussian_numpy", "mixture_gaussian_state_dict"]

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
