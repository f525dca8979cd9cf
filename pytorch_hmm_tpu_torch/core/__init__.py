"""Core DP recursions as plain torch code."""

from .semiring import LOG_ZERO, logsumexp, max_matvec, safe_log
from .viterbi import viterbi

__all__ = ["LOG_ZERO", "logsumexp", "max_matvec", "safe_log", "viterbi"]
