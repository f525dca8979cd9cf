"""Explicit-duration (HSMM) segment DP kernels for S ≤ 32 states.

Port of ``pytorch_hmm_tpu/ops/hsmm_smallk.py``: the segment Viterbi
(:func:`hsmm_smallk_viterbi`), the forward and backward sum recursions
(:func:`hsmm_smallk_forward`, :func:`hsmm_smallk_backward`) and both sum
chains in one launch (:func:`hsmm_smallk_fb`), for durations 1..D with
D ≤ 256; and the likelihood's cotangents from the sum chains' tables
(:func:`hsmm_table_grads`, ``csrc/hsmm_grads.cu``), which the JAX package
leaves to XLA.

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
from ..trace import span
from . import _build
from ._build import MAX_SMALLK, check_problem

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
    "hsmm_table_grads",
    "table_grads_plan",
    "viterbi_occupancy",
    "viterbi_plan",
]

# The Viterbi kernel's tables hold a duration index in a byte; its ring,
# duration terms and staging fill 176 KB of shared memory at S = 32, D =
# 256 (viterbi_plan).
MAX_DURATION = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_UNIT_LIB = _build.Library("smallk_sum", {
    "hmm_forward_sum_f32": [_P] * 7 + [_I] * 4 + [_P],
    "hmm_backward_sum_f32": [_P] * 6 + [_I] * 4 + [_P],
})
_LIB = _build.Library("hsmm_smallk", {
    "hsmm_forward_f32": [_P] * 7 + [_I] * 5 + [_P],
    "hsmm_backward_f32": [_P] * 6 + [_I] * 5 + [_P],
    "hsmm_fb_f32": [_P] * 9 + [_I] * 7 + [_P],
    "hsmm_viterbi_f32": [_P] * 9 + [_I] * 8 + [_P],
    "hsmm_viterbi_occupancy": [_I] * 6 + [_P],
})
# The phase probe of hsmm_fb: a separate build of csrc/hsmm_smallk.cu,
# never on an entry point's path (chip_smoke.py and kernel_ab.py read it).
PROBE_DEFINES = ("HSMM_SMALLK_PROBE",)
_PROBE_LIB = _build.Library("hsmm_smallk", {"hsmm_fb_probe_f32": [_P] * 10 + [_I] * 7 + [_P]},
                            PROBE_DEFINES)

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


# An H100 SM: its shared memory and the bytes it reserves a block there;
# a block's shared memory, and the threads and blocks the SM holds at once.
_SM_SHARED, _BLOCK_RESERVE = 233472, 1024
_SM_SMEM, _SM_THREADS, _SM_BLOCKS = 232448, 2048, 32
# Frames of log-obs the Viterbi kernel may stage at a time, and the window
# terms a lane takes in one unrolled pass.
_VIT_CHUNKS, _VIT_PASS = (64, 32, 16), 8


class ViterbiPlan(NamedTuple):
    """How ``hsmm_smallk_viterbi`` lays a chain out on its block of one
    warp: ``lanes`` (G) lanes a state, lane g·S + s taking state s's
    duration terms j = g + G·i, ``terms`` of them (padded to whole passes
    of 8), and its predecessors k = g + G·m; ``threads`` a block;
    ``stride`` floats a row of the (mu, C) ring (S float pairs: a frame's
    reads of a term by the G·S lanes are consecutive pairs); ``chunk``
    frames of log-obs staged at a time; ``smem`` bytes of shared memory."""

    lanes: int
    terms: int
    threads: int
    stride: int
    chunk: int
    smem: int


def _vit_smem(num_states: int, max_duration: int, lanes: int, terms: int, chunk: int) -> int:
    """The (R, S) ring of float pairs, R = max(2D, D + G·P) rows; the (P,
    32) lane-major duration terms; two chunks of log-obs."""
    rows = max(2 * max_duration, max_duration + lanes * terms)
    return 4 * (2 * rows * num_states + 32 * terms + 2 * chunk * num_states)


def _vit_chains(smem: int) -> int:
    """Blocks of ``smem`` shared bytes an SM holds, by shared memory."""
    return min(_SM_BLOCKS, _SM_SHARED // (smem + _BLOCK_RESERVE))


def viterbi_plan(num_states: int, max_duration: int) -> ViterbiPlan:
    """The layout of ``hsmm_smallk_viterbi`` at (S, D): as many lanes a
    state as fit in the warp (G = 32 // S), ceil(D / G) window terms a
    lane in passes of 8, and the longest staging chunk of 64, 32 or 16
    frames at which an SM holds as many chains as at 16;
    ``csrc/hsmm_smallk.cu`` (``check_viterbi_plan``) refuses any other
    lanes, chunk, or shared bytes short of the layout's."""
    S, D = num_states, max_duration
    g = 32 // S
    terms = -(-(-(-D // g)) // _VIT_PASS) * _VIT_PASS   # ceil(ceil(D / G) / 8) * 8
    fewest = _vit_chains(_vit_smem(S, D, g, terms, _VIT_CHUNKS[-1]))
    chunk = next(c for c in _VIT_CHUNKS if _vit_chains(_vit_smem(S, D, g, terms, c)) >= fewest)
    return ViterbiPlan(g, terms, 32, 2 * S, chunk, _vit_smem(S, D, g, terms, chunk))


def viterbi_occupancy(num_states: int, max_duration: int, device: torch.device) -> Tuple[int, int, int]:
    """``(chains an SM holds, registers a thread, bytes a thread spilled)``
    of the Viterbi kernel at :func:`viterbi_plan`'s layout on ``device``
    (builds the kernel)."""
    plan = viterbi_plan(num_states, max_duration)
    out = (ctypes.c_int * 3)()
    _build.check(_LIB.fn("hsmm_viterbi_occupancy")(num_states, max_duration, plan.lanes, plan.chunk,
                                                   plan.smem, device.index or 0, out),
                 "hsmm_smallk_viterbi occupancy")
    return out[0], out[1], out[2]


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
    with span("kernels.hsmm_smallk_forward"):
        what = "hsmm_smallk_forward"
        B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
        alpha = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
        log_z = torch.empty((B,), dtype=torch.float32, device=log_obs.device)
        _LIB.launch("hsmm_forward_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
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
    with span("kernels.hsmm_smallk_backward"):
        what = "hsmm_smallk_backward"
        B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, None, log_dur, lengths)
        beta_star = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
        beta_start = torch.empty_like(beta_star)
        _LIB.launch("hsmm_backward_f32", what, log_obs, log_a, log_dur, lengths,
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
        _LIB.launch("hsmm_fb_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
                    alpha, log_z, beta_star, beta_start, *tail)
    else:
        _PROBE_LIB.launch("hsmm_fb_probe_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
                          alpha, log_z, beta_star, beta_start, probe, *tail)
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
    row's final state. CUDA tensors run the kernel at
    :func:`viterbi_plan`'s layout (counted in
    ``hsmm_smallk_viterbi.launches``; those whose plan splits a state over
    several lanes, S ≤ 16, also in ``.split_launches``), CPU tensors the
    plain version.
    """
    if log_obs.device.type == "cpu":
        return hsmm_smallk_viterbi_reference(log_obs, log_a, log_pi, log_dur, lengths)
    with span("kernels.hsmm_smallk_viterbi"):
        what = "hsmm_smallk_viterbi"
        B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
        dev = log_obs.device
        dstar = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
        phi = torch.empty((B, T, K), dtype=torch.uint8, device=dev)
        states = torch.empty((B, T), dtype=torch.int32, device=dev)
        score = torch.empty((B,), dtype=torch.float32, device=dev)
        plan = viterbi_plan(K, D)
        _LIB.launch("hsmm_viterbi_f32", what, log_obs, log_a, log_pi, log_dur, lengths,
                    dstar, phi, states, score, B, T, K, D, plan.lanes, plan.chunk, plan.smem)
    hsmm_smallk_viterbi.launches += 1
    hsmm_smallk_viterbi.split_launches += plan.lanes > 1
    return states, score


# -- the likelihood's cotangents: csrc/hsmm_grads.cu -------------------------------

_GRADS_LIB = _build.Library("hsmm_grads", {"hsmm_table_grads_f32": [_P] * 16 + [_I] * 8 + [_P]})
# Frames a tile of hsmm_table_grads.
GRADS_TILE = 64


class GradsPlan(NamedTuple):
    """How ``hsmm_table_grads`` splits the batch: each row in ``parts``
    blocks of ``span`` frames (a block has a warp a state), ``smem``
    bytes of shared memory a block."""

    parts: int
    span: int
    smem: int


def table_grads_plan(num_states: int, max_duration: int, batch: int, frames: int,
                     sms: int) -> GradsPlan:
    """The split of ``hsmm_table_grads`` at (S, D, B, T) on a card of
    ``sms`` SMs: enough parts a row that the B * P blocks fill the card
    twice over at the blocks an SM holds, and no part shorter than a tile
    (one part a row once B alone does that); ``csrc/hsmm_grads.cu``
    refuses a split that leaves frames uncovered or too little shared
    memory."""
    S, D = num_states, max_duration
    smem = 4 * ((S | 1) * (7 * GRADS_TILE + 2 * D - 1) + S * S + S * D)
    resident = max(1, min(_SM_THREADS // (32 * S), _SM_SMEM // smem, _SM_BLOCKS))
    parts = max(1, min(-(-frames // GRADS_TILE), -(-2 * sms * resident // batch)))
    span = -(-frames // parts)
    return GradsPlan(-(-frames // span), span, smem)


def hsmm_table_grads(log_obs, log_a, log_pi, log_dur, log_alpha, log_bstar, log_bstart,
                     log_z, lengths, g):
    """Cotangents ``(d_log_obs, d_log_a, d_log_pi, d_log_dur)`` of ``Σ_b
    g_b · log Z_b`` from the forward and backward tables, as
    ``core.hsmm.hsmm_grads_from_tables``; zero at padded frames. CUDA
    tensors run the kernel, two launches (counted once a call in
    ``hsmm_table_grads.launches``): every float tensor float32 and
    contiguous, the tables ``(B, T, S)``, ``log_z`` and ``g`` ``(B,)``,
    ``lengths`` int32 or None, S ≤ 32, D ≤ 256, all on one device;
    anything else raises. The sums over the batch are taken in a fixed
    order, so the same inputs give the same gradients bit for bit. CPU
    tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return core.hsmm.hsmm_grads_from_tables(log_obs, log_a, log_pi, log_dur, log_alpha,
                                                log_bstar, log_bstart, log_z, lengths, g)
    with span("kernels.hsmm_table_grads"):
        what = "hsmm_table_grads"
        tables = dict(log_alpha=log_alpha, log_bstar=log_bstar, log_bstart=log_bstart)
        for name, t in dict(log_obs=log_obs, log_a=log_a, log_pi=log_pi, log_dur=log_dur,
                            **tables, log_z=log_z, g=g).items():
            if t.dtype != torch.float32:
                raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        for name, t, shape in (*((n, t, log_obs.shape) for n, t in tables.items()),
                               ("log_z", log_z, log_obs.shape[:1]), ("g", g, log_obs.shape[:1])):
            if t.shape != shape:
                raise ValueError(f"{what}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        B, T, K, D, lengths = _check_segment_problem(what, log_obs, log_a, log_pi, log_dur, lengths)
        dev = log_obs.device
        _build.check_tensors(what, dev, **tables, log_z=log_z, g=g)
        plan = table_grads_plan(K, D, B, T, torch.cuda.get_device_properties(dev).multi_processor_count)
        d_log_obs = torch.empty((B, T, K), dtype=torch.float32, device=dev)
        d_log_a = torch.empty((K, K), dtype=torch.float32, device=dev)
        d_log_pi = torch.empty((K,), dtype=torch.float32, device=dev)
        d_log_dur = torch.empty((K, D), dtype=torch.float32, device=dev)
        part = torch.empty((B * plan.parts, K * K + K + K * D), dtype=torch.float32, device=dev)
        tot = torch.empty((B * plan.parts, K), dtype=torch.float32, device=dev)
        _GRADS_LIB.launch("hsmm_table_grads_f32", what, log_obs, log_a, log_pi, log_dur,
                          log_alpha, log_bstar, log_bstart, log_z, lengths, g, d_log_obs, d_log_a,
                          d_log_pi, d_log_dur, part, tot, B, T, K, D, plan.parts, plan.span,
                          plan.smem)
    hsmm_table_grads.launches += 1
    return d_log_obs, d_log_a, d_log_pi, d_log_dur


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
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    _UNIT_LIB.launch("hmm_forward_sum_f32", "hsmm_smallk_forward", log_obs, log_a, log_pi, ld0,
                     lengths, alpha, log_z, B, T, K)
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
    beta_star = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    beta_start = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    _UNIT_LIB.launch("hmm_backward_sum_f32", "hsmm_smallk_backward", log_obs, log_a, ld0, lengths,
                     beta_star, beta_start, B, T, K)
    hsmm_smallk_backward.launches += 1
    return beta_star, beta_start


hsmm_smallk_forward.launches = 0
hsmm_smallk_backward.launches = 0
hsmm_smallk_forward_general.launches = 0
hsmm_smallk_backward_general.launches = 0
hsmm_smallk_fb.launches = 0
hsmm_smallk_viterbi.launches = 0
hsmm_smallk_viterbi.split_launches = 0
hsmm_table_grads.launches = 0
