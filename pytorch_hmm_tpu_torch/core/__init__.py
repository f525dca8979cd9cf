"""Core DP recursions as plain torch code."""

from .fb import (
    backward_log,
    forward_backward,
    forward_log,
    log_likelihood,
    xi_expectations,
    xi_sum,
)
from .hsmm import (
    hsmm_backward,
    hsmm_forward,
    hsmm_grads_from_tables,
    hsmm_log_z,
    hsmm_posteriors,
    hsmm_posteriors_from_tables,
    hsmm_viterbi,
)
from .semiring import (
    LOG_ZERO,
    log_matmul,
    log_matvec,
    log_matvec_t,
    logsumexp,
    max_matmul,
    max_matvec,
    normalize_log,
    safe_log,
)
from .sample import sample_one_hot, sample_states
from .viterbi import viterbi, viterbi_associative, viterbi_blocked

__all__ = [
    "LOG_ZERO",
    "log_matmul",
    "log_matvec",
    "log_matvec_t",
    "logsumexp",
    "max_matmul",
    "max_matvec",
    "normalize_log",
    "safe_log",
    "backward_log",
    "forward_backward",
    "forward_log",
    "log_likelihood",
    "xi_expectations",
    "xi_sum",
    "sample_one_hot",
    "sample_states",
    "viterbi",
    "viterbi_associative",
    "viterbi_blocked",
    "hsmm_backward",
    "hsmm_forward",
    "hsmm_grads_from_tables",
    "hsmm_log_z",
    "hsmm_posteriors",
    "hsmm_posteriors_from_tables",
    "hsmm_viterbi",
]
