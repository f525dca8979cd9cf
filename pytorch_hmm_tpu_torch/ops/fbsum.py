"""Fused HMM forward-backward: both sum chains in one launch.

Port of ``pytorch_hmm_tpu/ops/fbsum.py``. The alpha chain (t up) and the
beta chain (t down) are independent, so one launch runs both side by
side, one warp each (``csrc/smallk_sum.cu``), and the two tables cost
about one chain's time. It feeds the EM E-step
(``ops.auto_forward_backward``) and the ragged likelihood's forward
(``ops._pallas_ll_masked``).

On CUDA tensors (K ≤ 32, any T, ragged or not, static ``(K, K)`` or
time-varying ``(B, T, K, K)`` transitions) :func:`fbsum_smallk`
launches the kernel; on CPU tensors it runs
:func:`fbsum_smallk_reference`, ``core.fb.forward_log`` plus
``backward_log``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from . import _build
from ._build import MAX_SMALLK, check_problem

__all__ = ["fbsum_smallk", "fbsum_smallk_reference", "fbsum_supported"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("smallk_sum", {"fbsum_smallk_f32": [_P] * 7 + [_I] * 4 + [_P],
                                     "fbsum_smallk_tv_f32": [_P] * 7 + [_I] * 4 + [_P]})


def fbsum_supported(num_states: int, batch: int) -> bool:
    """True when the CUDA kernel takes ``num_states`` states (1 to 32, at
    any batch; the TPU kernel's VMEM bound of 16 does not apply)."""
    return 1 <= num_states <= MAX_SMALLK


def fbsum_smallk_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``core.fb.forward_log`` and ``backward_log``."""
    log_alpha, log_z = core.fb.forward_log(log_obs, log_a, log_pi, lengths)
    return log_alpha, core.fb.backward_log(log_obs, log_a, lengths), log_z


def fbsum_smallk(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(log_alpha (B, T, S), log_beta (B, T, S), log_z (B,))`` for
    static ``(S, S)`` or time-varying ``(B, T, S, S)`` log transitions
    (entry ``[:, t]`` governs the step into frame ``t``).

    Ragged rows (``lengths (B,)``): beta is 0 from each row's frame
    ``lengths[b] - 1`` on, and ``log_z`` is taken from alpha at that
    frame. Alpha past a row's end is unspecified, as in the JAX kernel;
    callers mask it. CUDA tensors run the kernel (counted in
    ``fbsum_smallk.launches``, the time-varying mode also in
    ``fbsum_smallk.time_varying_launches``): float32 and contiguous,
    ``lengths`` int32, all on one device; anything else raises. CPU
    tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return fbsum_smallk_reference(log_obs, log_a, log_pi, lengths)
    B, T, K, lengths = check_problem("fbsum_smallk", log_obs, log_a, log_pi, lengths,
                                     time_varying=True)
    _build.check_tensors("fbsum_smallk", log_obs.device, log_obs=log_obs,
                         log_a=log_a, log_pi=log_pi)
    dev = log_obs.device
    tv = log_a.ndim == 4
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    beta = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    _LIB.launch("fbsum_smallk_tv_f32" if tv else "fbsum_smallk_f32", "fbsum_smallk",
                log_obs, log_a, log_pi, lengths, alpha, beta, log_z, B, T, K)
    fbsum_smallk.launches += 1
    fbsum_smallk.time_varying_launches += tv
    return alpha, beta, log_z


fbsum_smallk.launches = 0
fbsum_smallk.time_varying_launches = 0
