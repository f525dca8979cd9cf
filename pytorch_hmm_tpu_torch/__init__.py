"""pytorch_hmm_tpu_torch — the HMM framework on PyTorch and CUDA.

The PyTorch port of ``pytorch_hmm_tpu``. Plain tensor code is torch; the
JAX package's Pallas kernels become CUDA C++ kernels written for Hopper
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``). So far
the port covers the GMM-HMM decode and training paths
(``MixtureGaussianHMMLayer`` with diag, tied or spherical covariances,
its emission scoring, Viterbi trellis, differentiable likelihood
``compute_loss`` and Baum-Welch ``em_step``, over the ``core``
forward-backward recursions) and the duration models (``HSMMLayer``,
``DurationConstrainedHMM``, ``DurationModel``, ``SemiMarkovHMM``,
``AdaptiveDurationHSMM``: decode, likelihood, posteriors, EM and
sampling over the ``core.hsmm`` segment DP) and streaming decode
(``StreamingHMMProcessor``, ``MultiStreamDecoder``, the on-device PCM
frontend ``DeviceFramer`` and ``make_pcm_decode_step``) and the neural
HMMs (``NeuralHMM``, ``ContextualNeuralHMM``, ``NeuralObservationModel``,
``NeuralTransitionModel``, and ``SemiMarkovHMM`` with neural emissions:
static or time-varying transitions, the fused neural emission kernel)
and the general-K path (``HMM``, ``HMMLayer``, ``GaussianHMMLayer`` and
every model above 32 states, to 1024: the general-K forward, backward
and Viterbi kernels, and the fused GMM decode) and long sequences (the
prob-space forward, backward and fused forward-backward kernels at
T ≥ 1024, K ≤ 128) and full-covariance Gaussian emissions in
``GaussianHMMLayer`` and ``MixtureGaussianHMMLayer`` and CTC
(``alignment``: ``CTCAligner`` loss, forced alignment and greedy / beam
decode on the lattice forward, backward and Viterbi kernels) and DTW
(``DTWAligner``, ``ConstrainedDTWAligner``, ``dtw_alignment`` on the
wavefront-and-backtrace kernel) and large-state scoring
(``ops.bigk_log_likelihood``, bf16 products on the tensor cores). Models are built
on the CUDA device unless ``device`` names another; on CPU tensors
everything runs as plain torch.

Importing the package imports neither JAX nor Triton and builds nothing.
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import alignment, bridge, core, durations, emissions, frontend, models, ops, precision, streaming, utils
from .alignment import (
    ConstrainedDTWAligner,
    CTCAligner,
    CTCSegmentationAligner,
    DTWAligner,
    ctc_alignment_path,
    dtw_alignment,
)
from .core import (
    backward_log,
    forward_backward,
    forward_log,
    hsmm_backward,
    hsmm_forward,
    hsmm_log_z,
    hsmm_posteriors,
    hsmm_viterbi,
    log_likelihood,
    sample_one_hot,
    sample_states,
    viterbi,
    viterbi_associative,
    viterbi_blocked,
)
from .emissions import (
    diag_gaussian_log_probs,
    full_gaussian_log_probs,
    gaussian_log_probs,
    gmm_component_log_probs,
    gmm_log_probs,
    spherical_gaussian_log_probs,
)
from .frontend import DeviceFramer, device_frames, framing_tables, make_pcm_decode_step
from .hmm import HMM, HMMJax, HMMPyTorch
from .models import (
    AdaptiveDurationHSMM,
    ContextualNeuralHMM,
    DurationConstrainedHMM,
    DurationModel,
    GaussianHMMLayer,
    HMMLayer,
    HSMMLayer,
    MixtureGaussianHMMLayer,
    NeuralHMM,
    NeuralObservationModel,
    NeuralTransitionModel,
    PreparedGMMDecoder,
    SemiMarkovHMM,
)
from .ops import (
    auto_forward,
    auto_forward_backward,
    auto_gmm_viterbi,
    auto_hsmm_forward,
    auto_hsmm_log_z,
    auto_hsmm_posteriors,
    auto_hsmm_viterbi,
    auto_log_likelihood,
    auto_viterbi,
)
from .streaming import (
    AdaptiveLatencyController,
    MultiStreamDecoder,
    StreamingHMMProcessor,
    StreamingResult,
)
from .utils import create_left_to_right_matrix, create_transition_matrix

__all__ = [
    "alignment",
    "bridge",
    "core",
    "durations",
    "emissions",
    "frontend",
    "models",
    "ops",
    "precision",
    "streaming",
    "utils",
    "viterbi",
    "viterbi_associative",
    "viterbi_blocked",
    "sample_one_hot",
    "sample_states",
    "forward_log",
    "backward_log",
    "forward_backward",
    "log_likelihood",
    "hsmm_backward",
    "hsmm_forward",
    "hsmm_log_z",
    "hsmm_posteriors",
    "hsmm_viterbi",
    "diag_gaussian_log_probs",
    "full_gaussian_log_probs",
    "gaussian_log_probs",
    "gmm_component_log_probs",
    "gmm_log_probs",
    "spherical_gaussian_log_probs",
    "AdaptiveDurationHSMM",
    "ConstrainedDTWAligner",
    "DTWAligner",
    "dtw_alignment",
    "CTCAligner",
    "CTCSegmentationAligner",
    "ctc_alignment_path",
    "ContextualNeuralHMM",
    "DurationConstrainedHMM",
    "DurationModel",
    "GaussianHMMLayer",
    "HMM",
    "HMMJax",
    "HMMLayer",
    "HMMPyTorch",
    "HSMMLayer",
    "MixtureGaussianHMMLayer",
    "NeuralHMM",
    "NeuralObservationModel",
    "NeuralTransitionModel",
    "PreparedGMMDecoder",
    "SemiMarkovHMM",
    "auto_forward",
    "auto_forward_backward",
    "auto_gmm_viterbi",
    "auto_hsmm_forward",
    "auto_hsmm_log_z",
    "auto_hsmm_posteriors",
    "auto_hsmm_viterbi",
    "auto_log_likelihood",
    "auto_viterbi",
    "AdaptiveLatencyController",
    "DeviceFramer",
    "MultiStreamDecoder",
    "StreamingHMMProcessor",
    "StreamingResult",
    "device_frames",
    "framing_tables",
    "make_pcm_decode_step",
    "create_left_to_right_matrix",
    "create_transition_matrix",
]
