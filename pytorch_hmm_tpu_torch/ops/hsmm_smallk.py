"""Explicit-duration (HSMM) segment DP kernels for S ≤ 32 states.

Port of ``pytorch_hmm_tpu/ops/hsmm_smallk.py``: the segment Viterbi
(:func:`hsmm_smallk_viterbi`), the forward and backward sum recursions
(:func:`hsmm_smallk_forward`, :func:`hsmm_smallk_backward`) and both sum
chains in one launch (:func:`hsmm_smallk_fb`), for durations 1..D with
D ≤ 256.

* D > 1 runs the kernels of ``csrc/hsmm_smallk.cu``. The forward and
  backward have wrappers of their own, :func:`hsmm_smallk_forward_general`
  and :func:`hsmm_smallk_backward_general`, which the D-routing wrappers
  call.
* D = 1, where an HSMM is an HMM and the two sum recursions are the
  likelihood's primal and VJP, keeps the HMM kernels of
  ``csrc/smallk_sum.cu``; ``log_dur[:, 0]`` is folded in as a per-state
  constant added to every frame.

On CUDA tensors every wrapper launches its kernel (counted in its
``.launches``) or raises; on CPU tensors it runs its plain version:
``core.hsmm`` for general D, ``core.fb`` for the D = 1 recursions. The
TPU kernels' batch cap (B ≤ 256) and VMEM budget are TPU matters: the
card takes any batch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import core
from . import _build
from .smallk import MAX_SMALLK, check_problem

__all__ = [
    "MAX_DURATION",
    "hsmm_smallk_backward",
    "hsmm_smallk_backward_general",
    "hsmm_smallk_backward_general_reference",
    "hsmm_smallk_backward_reference",
    "hsmm_smallk_fb",
    "hsmm_smallk_fb_reference",
    "hsmm_smallk_forward",
    "hsmm_smallk_forward_general",
    "hsmm_smallk_forward_general_reference",
    "hsmm_smallk_forward_reference",
    "hsmm_smallk_supported",
    "hsmm_smallk_viterbi",
    "hsmm_smallk_viterbi_reference",
]

# The duration rings, the duration table and the staging buffers of the
# Viterbi kernel fill 116 KB of shared memory at D = 256, and its tables
# hold a duration index in a byte.
MAX_DURATION = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_UNIT_SIGNATURES = {
    "hmm_forward_sum_f32": [_P] * 7 + [_I] * 4 + [_P],
    "hmm_backward_sum_f32": [_P] * 6 + [_I] * 4 + [_P],
}
_SIGNATURES = {
    "hsmm_forward_f32": [_P] * 7 + [_I] * 5 + [_P],
    "hsmm_backward_f32": [_P] * 6 + [_I] * 5 + [_P],
    "hsmm_fb_f32": [_P] * 9 + [_I] * 7 + [_P],
    "hsmm_viterbi_f32": [_P] * 9 + [_I] * 5 + [_P],
}
# The phase probe of hsmm_fb: a separate build of csrc/hsmm_smallk.cu,
# never on an entry point's path (chip_smoke.py and kernel_ab.py read it).
PROBE_DEFINES = ("HSMM_SMALLK_PROBE",)
_PROBE_SIGNATURES = {"hsmm_fb_probe_f32": [_P] * 10 + [_I] * 7 + [_P]}

# hsmm_fb's lane split: a helper lane takes at most FB_TERMS of a frame's
# older window terms (2 FB_TERMS once G reaches FB_MAX_LANES lanes a state).
FB_TERMS, FB_MAX_LANES = 8, 16
_CH, _KMAX = 64, 32


class FbPlan(NamedTuple):
    """How ``hsmm_smallk_fb`` splits a frame's window: ``lanes`` (G) helper
    lanes a state, each taking the ``terms`` (NJ) older terms j = 1 + g +
    G i; ``threads`` a block (the chain warp and the helper warps);
    ``stride`` of a state's ring row; ``smem`` bytes of shared memory."""

    lanes: int
    terms: int
    threads: int
    stride: int
    smem: int


def fb_plan(num_states: int, max_duration: int) -> FbPlan:
    """The lane split of ``hsmm_smallk_fb`` at (S, D): the fewest lanes a
    state (a power of two up to 16) that leave a lane at most 8 of the D -
    1 older window terms, 16 past that; ``csrc/hsmm_smallk.cu``
    (``hsmm_fb_launch``) refuses any other."""
    older = max_duration - 1
    g = 1
    while g < FB_MAX_LANES and -(-older // g) > FB_TERMS:
        g *= 2
    terms = FB_TERMS if -(-older // g) <= FB_TERMS else 2 * FB_TERMS
    threads = 32 * (1 + -(-num_states * g // 32))
    stride = -(-max_duration // 32) * 32 + g % 32
    smem = 4 * (2 * num_states * stride + 2 * _CH * num_states + 6 * _KMAX)
    return FbPlan(g, terms, threads, stride, smem)


def hsmm_smallk_supported(num_states: int, max_duration: int, batch: int) -> bool:
    """True when the CUDA kernels take the problem: 1 ≤ S ≤ 32 states,
    1 ≤ D ≤ 256 durations, any batch."""
    return 1 <= num_states <= MAX_SMALLK and 1 <= max_duration <= MAX_DURATION


def _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths):
    """Validate a CUDA launch; returns ``(B, T, K, D, lengths)``."""
    B, T, K, lengths = check_problem(what, log_obs, log_a, log_pi, lengths)
    if log_dur.ndim != 2 or log_dur.shape[0] != K or not 1 <= log_dur.shape[1] <= MAX_DURATION:
        raise ValueError(
            f"{what}: log_dur must be (K={K}, D) with 1 <= D <= {MAX_DURATION}, "
            f"got {tuple(log_dur.shape)}"
        )
    tensors = dict(log_obs=log_obs, log_a=log_a, log_dur=log_dur)
    if log_pi is not None:
        tensors["log_pi"] = log_pi
    _build.check_tensors(what, log_obs.device, **tensors)
    return B, T, K, log_dur.shape[1], lengths


def _launch(fn_name: str, what: str, *args, probe=False) -> None:
    dev = args[0].device
    lib = (_build.load("hsmm_smallk", _PROBE_SIGNATURES, PROBE_DEFINES) if probe
           else _build.load("hsmm_smallk", _SIGNATURES))
    ptrs = [None if a is None else a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = getattr(lib, fn_name)(*ptrs, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)


# -- plain versions -------------------------------------------------------------


def hsmm_smallk_forward_general_reference(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Plain version: ``core.hsmm.hsmm_forward``."""
    return core.hsmm.hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)


def hsmm_smallk_backward_general_reference(log_obs, log_a, log_dur, lengths=None):
    """Plain version: ``core.hsmm.hsmm_backward``."""
    return core.hsmm.hsmm_backward(log_obs, log_a, log_dur, lengths)


def hsmm_smallk_forward_reference(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Plain version: at D = 1 ``core.fb.forward_log`` of ``log_obs +
    log_dur[:, 0]``, otherwise ``core.hsmm.hsmm_forward``."""
    if log_dur.shape[-1] != 1:
        return hsmm_smallk_forward_general_reference(log_obs, log_a, log_pi, log_dur, lengths)
    return core.fb.forward_log(log_obs + log_dur[:, 0], log_a, log_pi, lengths)


def hsmm_smallk_backward_reference(log_obs, log_a, log_dur, lengths=None):
    """Plain version: at D = 1 ``beta* = core.fb.backward_log`` of
    ``log_obs + log_dur[:, 0]`` and ``beta_start = log_obs + log_dur[:, 0]
    + beta*``, otherwise ``core.hsmm.hsmm_backward``."""
    if log_dur.shape[-1] != 1:
        return hsmm_smallk_backward_general_reference(log_obs, log_a, log_dur, lengths)
    lo = log_obs + log_dur[:, 0]
    beta = core.fb.backward_log(lo, log_a, lengths)
    return beta, lo + beta


def hsmm_smallk_fb_reference(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Plain version: ``core.hsmm.hsmm_forward`` and ``hsmm_backward``."""
    log_alpha, log_z = core.hsmm.hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    log_bstar, log_bstart = core.hsmm.hsmm_backward(log_obs, log_a, log_dur, lengths)
    return log_alpha, log_z, log_bstar, log_bstart


def hsmm_smallk_viterbi_reference(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Plain version: ``core.hsmm.hsmm_viterbi``."""
    return core.hsmm.hsmm_viterbi(log_obs, log_a, log_pi, log_dur, lengths)


# -- general D: csrc/hsmm_smallk.cu ------------------------------------------------


def hsmm_smallk_forward_general(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM forward at any D ≤ 256: ``(log_alpha_star (B, T, S), log_z
    (B,))``, as ``core.hsmm.hsmm_forward``. Alpha is causal, so ragged
    rows are exact on their valid frames; later frames are unspecified.
    CUDA tensors run the kernel (counted in
    ``hsmm_smallk_forward_general.launches``): float32 and contiguous,
    ``lengths`` int32, all on one device; anything else raises. CPU
    tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return hsmm_smallk_forward_general_reference(log_obs, log_a, log_pi, log_dur, lengths)
    what = "hsmm_smallk_forward"
    B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
    log_z = torch.empty((B,), dtype=torch.float32, device=log_obs.device)
    _launch("hsmm_forward_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
            alpha, log_z, B, T, K, D)
    hsmm_smallk_forward_general.launches += 1
    return alpha, log_z


def hsmm_smallk_backward_general(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM backward at any D ≤ 256: ``(log_beta_star, log_beta_start)``,
    each ``(B, T, S)``, as ``core.hsmm.hsmm_backward``: ragged rows end
    at ``lengths[b] - 1`` and their padded log-obs count as zero; frames
    past a row's end are unspecified. CUDA tensors run the kernel
    (counted in ``hsmm_smallk_backward_general.launches``), CPU tensors
    the plain version.
    """
    if log_obs.device.type == "cpu":
        return hsmm_smallk_backward_general_reference(log_obs, log_a, log_dur, lengths)
    what = "hsmm_smallk_backward"
    B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, None, log_dur, lengths)
    beta_star = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
    beta_start = torch.empty_like(beta_star)
    _launch("hsmm_backward_f32", what, log_obs, log_a, log_dur, lengths,
            beta_star, beta_start, B, T, K, D)
    hsmm_smallk_backward_general.launches += 1
    return beta_star, beta_start


def hsmm_smallk_fb(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """Both HSMM sum chains in one launch: ``(log_alpha_star, log_z,
    log_beta_star, log_beta_start)``, the outputs of
    :func:`hsmm_smallk_forward_general` and
    :func:`hsmm_smallk_backward_general`. Unlike the TPU kernel it takes
    ``lengths``, so the posterior path makes one launch, ragged or not.
    CUDA tensors run the kernel (counted in ``hsmm_smallk_fb.launches``),
    CPU tensors the plain version.
    """
    if log_obs.device.type == "cpu":
        return hsmm_smallk_fb_reference(log_obs, log_a, log_pi, log_dur, lengths)
    out = _fb_launch(log_obs, log_a, log_pi, log_dur, lengths)
    hsmm_smallk_fb.launches += 1
    return out


def _fb_launch(log_obs, log_a, log_pi, log_dur, lengths, probe=None):
    """Launch ``hsmm_fb`` on checked CUDA inputs at :func:`fb_plan`'s
    split; with ``probe`` (an int64 ``(2, B, ceil(T / 64), 6)`` tensor)
    the probe build instead, which writes each role's cycles there."""
    what = "hsmm_smallk_fb"
    B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
    dev = log_obs.device
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    beta_star = torch.empty_like(alpha)
    beta_start = torch.empty_like(alpha)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    plan = fb_plan(K, D)
    tail = (B, T, K, D, plan.lanes, plan.smem)
    if probe is None:
        _launch("hsmm_fb_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
                alpha, log_z, beta_star, beta_start, *tail)
    else:
        _launch("hsmm_fb_probe_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
                alpha, log_z, beta_star, beta_start, probe, *tail, probe=True)
    return alpha, log_z, beta_star, beta_start


def hsmm_smallk_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batched HSMM Viterbi segmentation: ``(states (B, T) int32,
    score (B,))``, trellis and backtrace in one launch. Paths and scores
    are identical to ``core.hsmm.hsmm_viterbi``: ties go to the lowest
    duration, then the lowest predecessor, and padded frames repeat each
    row's final state. CUDA tensors run the kernel (counted in
    ``hsmm_smallk_viterbi.launches``), CPU tensors the plain version.
    """
    if log_obs.device.type == "cpu":
        return hsmm_smallk_viterbi_reference(log_obs, log_a, log_pi, log_dur, lengths)
    what = "hsmm_smallk_viterbi"
    B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
    dev = log_obs.device
    dstar = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
    phi = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    _launch("hsmm_viterbi_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
            dstar, phi, states, score, B, T, K, D)
    hsmm_smallk_viterbi.launches += 1
    return states, score


# -- D routing; D = 1 on csrc/smallk_sum.cu ---------------------------------------


def hsmm_smallk_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM forward: ``(log_alpha (B, T, S), log_z (B,))``.

    D > 1 goes to :func:`hsmm_smallk_forward_general`. At D = 1 CUDA
    tensors run the HMM forward kernel (counted in
    ``hsmm_smallk_forward.launches``); ragged rows are exact on their
    valid frames and ``log_z`` takes each row's frame ``lengths[b] - 1``.
    CPU tensors run the plain version.
    """
    if log_dur.shape[-1] != 1:
        return hsmm_smallk_forward_general(log_obs, log_a, log_pi, log_dur, lengths)
    if log_obs.device.type == "cpu":
        return hsmm_smallk_forward_reference(log_obs, log_a, log_pi, log_dur, lengths)
    B, T, K, lengths = check_problem("hsmm_smallk_forward", log_obs, log_a, log_pi, lengths)
    ld0 = log_dur[:, 0].contiguous()
    _build.check_tensors("hsmm_smallk_forward", log_obs.device, log_obs=log_obs,
                         log_a=log_a, log_pi=log_pi, log_dur=ld0)
    dev = log_obs.device
    ln_ptr = None if lengths is None else lengths.data_ptr()
    lib = _build.load("smallk_sum", _UNIT_SIGNATURES)
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    rc = lib.hmm_forward_sum_f32(
        log_obs.data_ptr(), log_a.data_ptr(), log_pi.data_ptr(), ld0.data_ptr(),
        ln_ptr, alpha.data_ptr(), log_z.data_ptr(), B, T, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "hsmm_smallk_forward")
    hsmm_smallk_forward.launches += 1
    return alpha, log_z


def hsmm_smallk_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_dur: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HSMM backward: ``(log_beta_star, log_beta_start)``, each
    ``(B, T, S)``. D > 1 goes to :func:`hsmm_smallk_backward_general`.
    At D = 1 ``beta*`` is the HMM's beta (0 from each row's frame
    ``lengths[b] - 1`` on) and ``beta_start = log_obs + log_dur[:, 0] +
    beta*`` on valid frames; CUDA tensors run the HMM backward kernel
    (counted in ``hsmm_smallk_backward.launches``), CPU tensors the plain
    version.
    """
    if log_dur.shape[-1] != 1:
        return hsmm_smallk_backward_general(log_obs, log_a, log_dur, lengths)
    if log_obs.device.type == "cpu":
        return hsmm_smallk_backward_reference(log_obs, log_a, log_dur, lengths)
    B, T, K, lengths = check_problem("hsmm_smallk_backward", log_obs, log_a, None, lengths)
    ld0 = log_dur[:, 0].contiguous()
    _build.check_tensors("hsmm_smallk_backward", log_obs.device, log_obs=log_obs,
                         log_a=log_a, log_dur=ld0)
    dev = log_obs.device
    ln_ptr = None if lengths is None else lengths.data_ptr()
    lib = _build.load("smallk_sum", _UNIT_SIGNATURES)
    beta_star = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    beta_start = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    rc = lib.hmm_backward_sum_f32(
        log_obs.data_ptr(), log_a.data_ptr(), ld0.data_ptr(), ln_ptr,
        beta_star.data_ptr(), beta_start.data_ptr(), B, T, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "hsmm_smallk_backward")
    hsmm_smallk_backward.launches += 1
    return beta_star, beta_start


hsmm_smallk_forward.launches = 0
hsmm_smallk_backward.launches = 0
hsmm_smallk_forward_general.launches = 0
hsmm_smallk_backward_general.launches = 0
hsmm_smallk_fb.launches = 0
hsmm_smallk_viterbi.launches = 0
