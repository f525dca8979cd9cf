"""Mixed precision and rematerialization flags.

Port of ``pytorch_hmm_tpu/precision.py``: the same two process-wide
flags, ``USE_MIXED_PRECISION`` and ``USE_CHECKPOINTING``, both on by
default, and ``compute_dtype``.

On the H100 the mixed flag is meant to select bf16 or TF32 tensor-core
contractions for emission scoring. No kernel of this package has such
a path yet: ``ops.emit.diag_quadratic`` and ``ops.smallk.smallk_viterbi``
compute in true float32 whatever the flag says, and ``compute_dtype``
resolves to float32 unless the caller overrides it. The checkpointing
flag is read by nothing until the training slice lands.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "mixed_precision_enabled",
    "set_mixed_precision",
    "checkpointing_enabled",
    "set_checkpointing",
    "compute_dtype",
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
