"""Model layers (``torch.nn.Module``s) on the shared DP code.

The JAX package's ``models/common.py`` (``Buffer``, ``TrainMode``) has
no counterpart here: ``nn.Module.register_buffer`` and
``nn.Module.train()`` / ``eval()`` already do its job.
"""

from .hmm_layer import GaussianHMMLayer, HMMLayer
from .hsmm import DurationConstrainedHMM, HSMMLayer
from .mixture_gaussian import MixtureGaussianHMMLayer, PreparedGMMDecoder
from .neural import ContextualNeuralHMM, NeuralHMM, NeuralObservationModel, NeuralTransitionModel
from .semi_markov import AdaptiveDurationHSMM, DurationModel, SemiMarkovHMM

__all__ = [
    "AdaptiveDurationHSMM",
    "ContextualNeuralHMM",
    "DurationConstrainedHMM",
    "DurationModel",
    "GaussianHMMLayer",
    "HMMLayer",
    "HSMMLayer",
    "MixtureGaussianHMMLayer",
    "NeuralHMM",
    "NeuralObservationModel",
    "NeuralTransitionModel",
    "PreparedGMMDecoder",
    "SemiMarkovHMM",
]
