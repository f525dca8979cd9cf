"""Mixed precision and rematerialization flags.

Port of ``pytorch_hmm_tpu/precision.py``: the same two process-wide
flags, ``USE_MIXED_PRECISION`` and ``USE_CHECKPOINTING``, both on by
default, ``compute_dtype``, ``mxu_einsum`` and ``maybe_remat``.

On the H100 the mixed flag is meant to select bf16 or TF32 tensor-core
contractions for emission scoring. No kernel of this package has such
a path yet: every kernel (``ops.emit``, ``ops.smallk``, ``ops.fbsum``,
``ops.hsmm_smallk``) computes in true float32 whatever the flag says,
as the gradients and EM statistics need posterior-grade accuracy, and
``compute_dtype`` resolves to float32 unless the caller overrides it.
An explicit ``torch.bfloat16`` override rounds a contraction's operands
to bf16 with float32 accumulation (``mxu_einsum``), in plain torch.
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
    "mxu_einsum",
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


def mxu_einsum(spec: str, *operands: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.einsum`` under the precision policy, with a float32 result
    (float64 operands stay float64).

    * ``dtype=torch.bfloat16``, passed explicitly: the operands are
      rounded to bf16 and every product and sum runs in float32 (a
      product of two bf16 values is exact in float32), as the JAX
      package's explicit bf16 request off the TPU.
    * anything else: true float32 products (TF32 stays off).
    """
    if dtype is not None and compute_dtype(dtype) == torch.bfloat16:
        operands = tuple(x.to(torch.bfloat16).to(torch.float32) for x in operands)
    else:
        operands = tuple(x if x.dtype == torch.float64 else x.to(torch.float32) for x in operands)
    return torch.einsum(spec, *operands)


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
