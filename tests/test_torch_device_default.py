"""Every public model constructor of the torch port builds on the card
unless the caller names another device: with no card, constructing on
the default raises, as torch does, and never falls back to the CPU; with
``device="cpu"`` the draws are the CPU's, unchanged."""

import functools
import inspect

import pytest
import torch

from pytorch_hmm_tpu_torch import (
    AdaptiveDurationHSMM,
    CTCAligner,
    CTCSegmentationAligner,
    ConstrainedDTWAligner,
    ContextualNeuralHMM,
    DTWAligner,
    DeviceFramer,
    DurationConstrainedHMM,
    DurationModel,
    GaussianHMMLayer,
    HMM,
    HMMLayer,
    HSMMLayer,
    MixtureGaussianHMMLayer,
    NeuralHMM,
    NeuralObservationModel,
    NeuralTransitionModel,
    SemiMarkovHMM,
    StreamingHMMProcessor,
)

CONSTRUCTORS = {
    "MixtureGaussianHMMLayer": (MixtureGaussianHMMLayer, (3, 2)),
    "HSMMLayer": (HSMMLayer, (3, 2)),
    "DurationConstrainedHMM": (DurationConstrainedHMM, (3, 2)),
    "DurationModel": (DurationModel, (3,)),
    "SemiMarkovHMM": (SemiMarkovHMM, (3, 2)),
    "AdaptiveDurationHSMM": (AdaptiveDurationHSMM, (3, 2, 2)),
    "StreamingHMMProcessor": (StreamingHMMProcessor, (3, 2)),
    "NeuralHMM": (NeuralHMM, (3, 2)),
    "ContextualNeuralHMM": (ContextualNeuralHMM, (3, 2, 5)),
    "NeuralObservationModel": (NeuralObservationModel, (3, 2)),
    "NeuralTransitionModel": (NeuralTransitionModel, (3, 2)),
    "DeviceFramer": (DeviceFramer, ()),
    "HMMLayer": (HMMLayer, (3,)),
    "GaussianHMMLayer": (GaussianHMMLayer, (3, 2)),
    "HMM": (HMM, ([[0.5, 0.5], [0.5, 0.5]],)),
    "GaussianHMMLayer full": (functools.partial(GaussianHMMLayer, covariance_type="full"), (3, 2)),
    "MixtureGaussianHMMLayer full": (
        functools.partial(MixtureGaussianHMMLayer, covariance_type="full"), (3, 2)),
    "CTCAligner": (CTCAligner, (40,)),
    "CTCSegmentationAligner": (CTCSegmentationAligner, (40,)),
    "DTWAligner": (DTWAligner, ()),
    "ConstrainedDTWAligner": (ConstrainedDTWAligner, (10,)),
}


def _device_of(obj) -> torch.device:
    if isinstance(obj, (CTCAligner, DTWAligner)):   # no parameters: the device inputs move to
        return obj.device
    if isinstance(obj, torch.nn.Module):
        return next(obj.parameters()).device
    if isinstance(obj, HMM):
        return obj.P.device
    return obj.tables["cos"].device


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    cls, args = CONSTRUCTORS[name]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert _device_of(cls(*args)).type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            cls(*args)
    assert _device_of(cls(*args, device="cpu")).type == "cpu"


def test_cpu_draws_are_the_generators():
    """Weights come from the caller's CPU generator, or one seeded with 0."""
    a = HSMMLayer(3, 2, device="cpu")
    b = HSMMLayer(3, 2, device="cpu", generator=torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    g = torch.Generator().manual_seed(0)
    assert torch.equal(a.transition_logits, torch.randn((3, 3), generator=g) * 0.1)
