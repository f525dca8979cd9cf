"""Mixed precision and rematerialization flags.

Port of ``pytorch_hmm_tpu/precision.py``: the same two process-wide
flags, ``USE_MIXED_PRECISION`` and ``USE_CHECKPOINTING``, both on by
default, ``compute_dtype`` and ``maybe_remat``.

On the H100 the mixed flag is meant to select bf16 or TF32 tensor-core
contractions for emission scoring. No kernel of this package has such
a path yet: every kernel (``ops.emit``, ``ops.smallk``, ``ops.fbsum``,
``ops.hsmm_smallk``) computes in true float32 whatever the flag says,
as the gradients and EM statistics need posterior-grade accuracy, and
``compute_dtype`` resolves to float32 unless the caller overrides it.
The checkpointing flag is read by ``maybe_remat``, which the GMM layer's
``log_likelihood`` wraps around its emission scoring.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint

__all__ = [
    "mixed_precision_enabled",
    "set_mixed_precision",
    "checkpointing_enabled",
    "set_checkpointing",
    "compute_dtype",
    "maybe_remat",
]

_MIXED_PRECISION = True
_CHECKPOINTING = True


def mixed_precision_enabled() -> bool:
    return _MIXED_PRECISION


def set_mixed_precision(enabled: bool) -> None:
    global _MIXED_PRECISION
    _MIXED_PRECISION = bool(enabled)


def checkpointing_enabled() -> bool:
    return _CHECKPOINTING


def set_checkpointing(enabled: bool) -> None:
    global _CHECKPOINTING
    _CHECKPOINTING = bool(enabled)


def compute_dtype(override: Optional[torch.dtype] = None) -> torch.dtype:
    """The multiply dtype of emission contractions: ``override`` when
    given, else float32 (the only precision this package's kernels
    compute in so far)."""
    if override is not None:
        return override
    return torch.float32


def maybe_remat(fn: Callable) -> Callable:
    """``fn`` recomputed in the backward pass instead of keeping its
    intermediates (``torch.utils.checkpoint``, non-reentrant) when
    checkpointing is enabled as ``maybe_remat`` is called; ``fn`` itself
    otherwise."""
    if not _CHECKPOINTING:
        return fn

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return remat
