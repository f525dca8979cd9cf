"""Hand-written CUDA kernels for the hot HMM ops, and decode dispatch.

Port of the decode half of ``pytorch_hmm_tpu/ops/__init__.py``. The
device decides the path, as the backend does in the JAX package:

* CUDA tensors with K ≤ 32 run the hand kernels
  (``emit.diag_quadratic`` for diag/tied emissions,
  ``smallk.smallk_viterbi`` for the trellis). A CUDA case this package
  has no kernel for yet raises ``NotImplementedError`` naming its ROADMAP
  item; it never falls back to the plain torch path.
* CPU tensors run the plain torch versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import core
from .emit import diag_quadratic, diag_quadratic_reference
from .smallk import (
    MAX_SMALLK,
    smallk_supported,
    smallk_viterbi,
    smallk_viterbi_reference,
)

__all__ = [
    "auto_viterbi",
    "auto_gmm_viterbi",
    "diag_quadratic",
    "diag_quadratic_reference",
    "smallk_viterbi",
    "smallk_viterbi_reference",
    "smallk_supported",
    "MAX_SMALLK",
]


def _unported_trellis(K: int) -> NotImplementedError:
    return NotImplementedError(
        f"no CUDA trellis kernel for K={K} > {MAX_SMALLK} states yet: "
        "ROADMAP queue 2 rows 13 (pallas_viterbi) and 14 (fused_gmm_viterbi)"
    )


def _lengths_on(lengths: Optional[torch.Tensor], device: torch.device):
    if lengths is None:
        return None
    return torch.as_tensor(lengths).to(device=device, dtype=torch.int32).contiguous()


def auto_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(states (B, T) int32, score (B,))`` — the CUDA trellis kernel
    on CUDA tensors (K ≤ 32), the plain ``core.viterbi`` on CPU. Paths
    are identical on both, tie-breaks included."""
    K = log_obs.shape[-1]
    if log_obs.device.type == "cpu":
        return core.viterbi(log_obs, log_a, log_pi, lengths)
    if log_a.ndim != 2:
        raise NotImplementedError(
            "no CUDA kernel for time-varying (B, T, K, K) transitions yet: "
            "ROADMAP queue 1 item 8 (NeuralHMM)"
        )
    if not smallk_supported(K):
        raise _unported_trellis(K)
    return smallk_viterbi(
        log_obs.float().contiguous(), log_a.float().contiguous(),
        log_pi.float().contiguous(), _lengths_on(lengths, log_obs.device),
    )


def auto_gmm_viterbi(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: torch.Tensor,
    log_w: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    covariance_type: str = "diag",
):
    """GMM-HMM decode ``(states, score)`` — the decode path.

    Emission scoring (``emissions.gmm_log_probs``: the ``diag_quadratic``
    kernel for diag and tied covariances on CUDA) into
    :func:`auto_viterbi`. On CUDA, more than 32 states raises before any
    work: the JAX package sends them to ``fused_gmm_viterbi`` or
    ``pallas_viterbi``, which are not ported yet.
    """
    from ..emissions import gmm_log_probs

    S = log_w.shape[0]
    if obs.device.type == "cuda" and not smallk_supported(S):
        raise _unported_trellis(S)
    log_obs = gmm_log_probs(obs, means, cov_params, log_w, covariance_type)
    return auto_viterbi(log_obs, log_a, log_pi, lengths)
