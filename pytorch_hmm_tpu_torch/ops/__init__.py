"""Hand-written CUDA kernels for the hot HMM ops, and their dispatch.

Port of ``pytorch_hmm_tpu/ops/__init__.py``. The device decides the
path, as the backend does in the JAX package:

* CUDA tensors with K ≤ 32 run the hand kernels: ``emit.diag_quadratic``
  for diag/tied emissions, ``emit_mlp.fused_gaussian_emission`` for the
  neural gaussian head, ``smallk.smallk_viterbi`` for decode,
  ``hsmm_smallk`` (forward and backward sum recursions at D = 1) for the
  likelihood and its gradient, ``fbsum.fbsum_smallk`` for posteriors and
  the ragged likelihood. Time-varying ``(B, T, K, K)`` transitions (the
  neural HMMs'), which the JAX package sends to its XLA scans, run the
  time-varying modes of ``smallk_viterbi`` and ``fbsum_smallk``, the
  likelihood too. Every K ≤ 32 goes to them at any T, ragged or not: the
  TPU kernels' VMEM gates (fbsum's 16 states and T < 1024) and the
  long-T switch to the prob-space kernels are TPU matters. A CUDA case
  this package has no kernel for yet (K > 32) raises
  ``NotImplementedError`` naming its ROADMAP row; it never falls back to
  the plain torch path.
* The duration models' segment DP (``auto_hsmm_viterbi``,
  ``auto_hsmm_log_z``, ``auto_hsmm_posteriors``): CUDA tensors with
  S ≤ 32 states and D ≤ 256 durations run the ``hsmm_smallk`` kernels,
  the sum chains on max-shifted emissions. Larger shapes, which the JAX
  package never gives a kernel either, run the plain ``core.hsmm_*`` on
  the tensors' own device; a shape the kernels take never lands there
  because a build or launch failed, which raises.
* The streaming chunk decoders (``auto_greedy_chunk``,
  ``auto_beam_chunk_multi``): CUDA tensors inside the JAX kernels'
  envelope (S ≤ 128, W ≤ min(8, S), T and H ≤ 1024; any number of
  streams) run ``stream.greedy_chunk`` and ``stream_multi.beam_chunk_multi``.
  Larger shapes, which the JAX package sends to its XLA scan on every
  backend, run the plain versions on the tensors' own device.
* CPU tensors run the plain torch versions (``core``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import core
from .emit import diag_quadratic, diag_quadratic_reference
from .emit_mlp import (
    fused_emission_supported,
    fused_gaussian_emission,
    fused_gaussian_emission_reference,
)
from .fbsum import fbsum_smallk, fbsum_smallk_reference, fbsum_supported
from .hsmm_smallk import (
    MAX_DURATION,
    hsmm_smallk_backward,
    hsmm_smallk_backward_general,
    hsmm_smallk_backward_general_reference,
    hsmm_smallk_backward_reference,
    hsmm_smallk_fb,
    hsmm_smallk_fb_reference,
    hsmm_smallk_forward,
    hsmm_smallk_forward_general,
    hsmm_smallk_forward_general_reference,
    hsmm_smallk_forward_reference,
    hsmm_smallk_supported,
    hsmm_smallk_viterbi,
    hsmm_smallk_viterbi_reference,
)
from .smallk import (
    MAX_SMALLK,
    smallk_supported,
    smallk_viterbi,
    smallk_viterbi_reference,
)
from .stream import greedy_chunk, greedy_chunk_reference, stream_chunk_supported
from .stream_multi import beam_chunk_multi, beam_chunk_multi_reference, multi_stream_supported

__all__ = [
    "auto_beam_chunk_multi",
    "auto_greedy_chunk",
    "beam_chunk_multi",
    "beam_chunk_multi_reference",
    "greedy_chunk",
    "greedy_chunk_reference",
    "multi_stream_supported",
    "stream_chunk_supported",
    "auto_forward",
    "auto_forward_backward",
    "auto_log_likelihood",
    "auto_viterbi",
    "auto_gmm_viterbi",
    "auto_hsmm_forward",
    "auto_hsmm_log_z",
    "auto_hsmm_posteriors",
    "auto_hsmm_viterbi",
    "pallas_hsmm_log_z",
    "pallas_log_likelihood",
    "diag_quadratic",
    "diag_quadratic_reference",
    "fused_emission_supported",
    "fused_gaussian_emission",
    "fused_gaussian_emission_reference",
    "fbsum_smallk",
    "fbsum_smallk_reference",
    "fbsum_supported",
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
    "MAX_DURATION",
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


def _check_sum_path(log_obs: torch.Tensor) -> None:
    """Raise for a CUDA sum-recursion problem no kernel takes yet."""
    K = log_obs.shape[-1]
    if not fbsum_supported(K, log_obs.shape[0]):
        raise NotImplementedError(
            f"no CUDA sum-recursion kernel for K={K} > {MAX_SMALLK} states yet: "
            "ROADMAP queue 2 rows 8 (pallas_forward), 9 (pallas_backward) and "
            "12 (pallas_fb_prob)"
        )


def _f32(*tensors):
    return tuple(t.float().contiguous() for t in tensors)


def _lengths_on(lengths: Optional[torch.Tensor], device: torch.device):
    if lengths is None:
        return None
    return torch.as_tensor(lengths).to(device=device, dtype=torch.int32).contiguous()


def _unit_durations(log_obs: torch.Tensor) -> torch.Tensor:
    """``log_dur (K, 1)`` of zeros: an HMM is an HSMM whose segments last
    one frame."""
    return torch.zeros((log_obs.shape[-1], 1), dtype=torch.float32, device=log_obs.device)


def _valid_frames(lengths: torch.Tensor, T: int, start: int = 0) -> torch.Tensor:
    """``(B, T - start)`` mask of frames ``t >= start`` inside each row."""
    return torch.arange(start, T, device=lengths.device)[None, :] < lengths[:, None]


def _frame_shift(log_obs: torch.Tensor, lengths=None) -> torch.Tensor:
    """Each frame's largest emission ``(B, T, 1)``, zero past each row's
    end.

    Raw log-alpha reaches |T·log p| ~ 1e5 at speech shapes (log Z ≈
    -1.5e5 at B=32, T=1000, D=80), where one f32 ulp is ~1e-2, and
    posteriors formed as ``exp(alpha + beta - log Z)`` absorb that as
    error. Subtracting this shift from the emissions adds one constant
    per frame to every state's alpha + beta, so the posteriors are
    unchanged mathematically but computed at O(1e3) magnitudes; the sum
    of the shift is added back to log Z.
    """
    shift = torch.amax(log_obs, dim=-1, keepdim=True)
    if lengths is not None:
        shift = torch.where(_valid_frames(lengths, log_obs.shape[1])[..., None], shift, 0.0)
    return shift


class _LogLikelihood(torch.autograd.Function):
    """``log Z (B,)`` with the closed-form posterior gradients
    (``∂ log Z/∂ log_obs = γ``, ``∂/∂ log_a = Σ_t ξ_t``,
    ``∂/∂ log_pi = γ_0``). Forward: the D = 1 forward sum kernel;
    backward: the D = 1 backward sum kernel, then ``γ`` and
    ``core.fb.xi_expectations`` in plain torch (XLA in the JAX package).
    Both chains run on max-shifted emissions (:func:`_frame_shift`),
    which the shift cancels out of every posterior."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi):
        shift = _frame_shift(log_obs)
        lo_hat = (log_obs - shift).contiguous()
        alpha_hat, lz_hat = hsmm_smallk_forward(lo_hat, log_a, log_pi, _unit_durations(log_obs))
        ctx.save_for_backward(lo_hat, log_a, alpha_hat, lz_hat)
        return lz_hat + shift.sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        lo_hat, log_a, alpha_hat, lz_hat = ctx.saved_tensors
        beta_hat = hsmm_smallk_backward(lo_hat, log_a, _unit_durations(lo_hat))[0]
        log_gamma = alpha_hat + beta_hat - lz_hat[:, None, None]
        d_log_obs = g[:, None, None] * torch.exp(log_gamma)
        d_log_pi = torch.sum(g[:, None] * torch.exp(log_gamma[:, 0]), dim=0)
        lxi = core.fb.xi_expectations(alpha_hat, beta_hat, lo_hat, log_a, lz_hat)
        d_log_a = torch.sum(g[:, None, None] * torch.exp(lxi), dim=0)
        return d_log_obs, d_log_a, d_log_pi


class _FBLogLikelihood(torch.autograd.Function):
    """``log Z (B,)`` of ragged rows, time-varying ``(B, T, K, K)``
    transitions, or both: ``fbsum_smallk`` gives alpha and beta in one
    launch (the backward always needs beta). The gradients are the
    posteriors of valid frames and of transitions that land inside each
    row (``t + 1 < lengths[b]``), zero elsewhere; for time-varying
    ``log_a`` the per-frame ξ ``(B, T, K, K)``, zero at ``t = 0``.
    Max-shifted as :class:`_LogLikelihood` is."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi, lengths):
        shift = _frame_shift(log_obs, lengths)
        lo_hat = (log_obs - shift).contiguous()
        alpha_hat, beta_hat, lz_hat = fbsum_smallk(lo_hat, log_a, log_pi, lengths)
        ctx.save_for_backward(lo_hat, log_a, lengths, alpha_hat, beta_hat, lz_hat)
        return lz_hat + shift.sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        lo_hat, log_a, lengths, alpha_hat, beta_hat, lz_hat = ctx.saved_tensors
        T = lo_hat.shape[1]
        tv = log_a.ndim == 4
        log_gamma = alpha_hat + beta_hat - lz_hat[:, None, None]
        gamma = torch.exp(log_gamma)
        if lengths is not None:
            gamma = torch.where(_valid_frames(lengths, T)[..., None], gamma, 0.0)
        d_log_obs = g[:, None, None] * gamma
        d_log_pi = torch.sum(g[:, None] * torch.exp(log_gamma[:, 0]), dim=0)
        lxi = (
            alpha_hat[:, :-1, :, None]
            + (log_a[:, 1:] if tv else log_a)
            + (lo_hat + beta_hat)[:, 1:, None, :]
            - lz_hat[:, None, None, None]
        )
        xi = torch.exp(lxi)
        if lengths is not None:
            xi = torch.where(_valid_frames(lengths, T, 1)[..., None, None], xi, 0.0)
        if tv:
            d_log_a = torch.cat([torch.zeros_like(xi[:, :1]), g[:, None, None, None] * xi], 1)
        else:
            d_log_a = torch.sum(g[:, None, None] * torch.sum(xi, dim=1), dim=0)
        return d_log_obs, d_log_a, d_log_pi, None


def pallas_log_likelihood(log_obs, log_a, log_pi):
    """Differentiable sequence log-likelihood ``(B,)`` on the forward and
    backward sum kernels (their plain versions on CPU tensors)."""
    return _LogLikelihood.apply(log_obs, log_a, log_pi)


def _pallas_ll_masked(log_obs, log_a, log_pi, lengths):
    """Ragged or time-varying twin of :func:`pallas_log_likelihood` on
    ``fbsum_smallk``; ``lengths`` is None or int32 ``(B,)`` on the
    tensors' device."""
    return _FBLogLikelihood.apply(log_obs, log_a, log_pi, lengths)


def auto_log_likelihood(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """Differentiable ``log Z (B,)``: the sum kernels with closed-form
    posterior gradients on CUDA tensors (K ≤ 32; static and unragged on
    the D = 1 forward and backward kernels, ragged or time-varying on
    ``fbsum_smallk``), autograd through the plain ``core.log_likelihood``
    scan on CPU."""
    if log_obs.device.type == "cpu":
        return core.log_likelihood(log_obs, log_a, log_pi, lengths)
    _check_sum_path(log_obs)
    args = _f32(log_obs, log_a, log_pi)
    if lengths is None and log_a.ndim == 2:
        return pallas_log_likelihood(*args)
    return _pallas_ll_masked(*args, _lengths_on(lengths, log_obs.device))


def auto_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(log_alpha, log_z)`` — the D = 1 forward sum kernel on CUDA
    tensors (for time-varying transitions alpha and log Z of one
    ``fbsum_smallk`` launch), ``core.forward_log`` on CPU. Past each
    row's end alpha holds its final valid value, as ``core`` freezes
    it."""
    if log_obs.device.type == "cpu":
        return core.forward_log(log_obs, log_a, log_pi, lengths)
    _check_sum_path(log_obs)
    ln = _lengths_on(lengths, log_obs.device)
    if log_a.ndim == 2:
        log_alpha, log_z = hsmm_smallk_forward(*_f32(log_obs, log_a, log_pi),
                                               _unit_durations(log_obs), ln)
    else:
        log_alpha, _, log_z = fbsum_smallk(*_f32(log_obs, log_a, log_pi), ln)
    if ln is not None:
        log_alpha = _freeze_past_end(log_alpha, ln)
    return log_alpha, log_z


def _freeze_past_end(log_alpha: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's frames ``t >= lengths[b]`` replaced by its frame
    ``lengths[b] - 1`` (the kernel runs on through them)."""
    B, T, K = log_alpha.shape
    t = torch.arange(T, device=lengths.device)
    idx = torch.minimum(t[None, :], (lengths - 1).long()[:, None])
    return log_alpha.gather(1, idx[..., None].expand(B, T, K))


def _shifted_forward_backward(log_obs, log_a, log_pi, lengths=None):
    """``fbsum_smallk`` on max-shifted emissions (:func:`_frame_shift`),
    with the cumulative shift re-added to alpha, beta and log Z so the
    outputs stay raw."""
    shift = _frame_shift(log_obs, lengths)
    alpha_hat, beta_hat, lz_hat = fbsum_smallk(
        (log_obs - shift).contiguous(), log_a, log_pi, lengths
    )
    lg = alpha_hat + beta_hat
    log_gamma = lg - core.logsumexp(lg, dim=-1, keepdim=True)
    csh = torch.cumsum(shift, dim=1)                           # Σ_{u<=t} shift
    total = csh[:, -1]                                         # padded frames add 0
    log_alpha = alpha_hat + csh
    log_beta = beta_hat + (total[:, None] - csh)
    log_z = lz_hat + total[:, 0]
    return log_gamma, log_alpha, log_beta, log_z


def auto_forward_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(log_gamma, log_alpha, log_beta, log_z)`` — ``fbsum_smallk`` on
    max-shifted emissions on CUDA tensors, ``core.forward_backward`` on
    CPU. The posterior normalization matches ``core`` exactly. Static or
    time-varying transitions."""
    if log_obs.device.type == "cpu":
        return core.forward_backward(log_obs, log_a, log_pi, lengths)
    _check_sum_path(log_obs)
    return _shifted_forward_backward(*_f32(log_obs, log_a, log_pi),
                                     _lengths_on(lengths, log_obs.device))


def auto_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(states (B, T) int32, score (B,))`` — the CUDA trellis kernel
    on CUDA tensors (K ≤ 32, static or time-varying transitions), the
    plain ``core.viterbi`` on CPU. Paths are identical on both,
    tie-breaks included."""
    K = log_obs.shape[-1]
    if log_obs.device.type == "cpu":
        return core.viterbi(log_obs, log_a, log_pi, lengths)
    if not smallk_supported(K):
        raise _unported_trellis(K)
    return smallk_viterbi(*_f32(log_obs, log_a, log_pi), _lengths_on(lengths, log_obs.device))


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


# -- duration models ------------------------------------------------------------


def _hsmm_kernel_route(log_obs: torch.Tensor, log_dur: torch.Tensor) -> bool:
    """True when the segment DP goes to the ``hsmm_smallk`` kernels: any
    device but the CPU (CUDA, or a device the kernels then refuse), with
    a shape the kernels take."""
    B, _, S = log_obs.shape
    return log_obs.device.type != "cpu" and hsmm_smallk_supported(S, log_dur.shape[-1], B)


class _HSMMLogZ(torch.autograd.Function):
    """HSMM ``log Z (B,)``, ragged when ``lengths`` is given, with the
    closed-form posterior-expectation cotangents. Forward: the forward
    sum kernel; backward: the backward sum kernel, then
    ``core.hsmm_grads_from_tables`` in plain torch. Both chains run on
    emissions shifted by each frame's max (:func:`_frame_shift`): every
    segmentation emits each frame once, so the shift moves log Z by its
    sum and cancels from every posterior, and the chains stay at O(1e3)
    where raw ones reach O(1e5)."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi, log_dur, lengths):
        shift = _frame_shift(log_obs, lengths)
        lo_hat = (log_obs - shift).contiguous()
        alpha_hat, lz_hat = hsmm_smallk_forward(lo_hat, log_a, log_pi, log_dur, lengths)
        ctx.save_for_backward(lo_hat, log_a, log_pi, log_dur, lengths, alpha_hat, lz_hat)
        return lz_hat + shift.sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        lo_hat, log_a, log_pi, log_dur, lengths, alpha_hat, lz_hat = ctx.saved_tensors
        bstar, bstart = hsmm_smallk_backward(lo_hat, log_a, log_dur, lengths)
        grads = core.hsmm_grads_from_tables(lo_hat, log_a, log_pi, log_dur, alpha_hat,
                                            bstar, bstart, lz_hat, lengths, g.contiguous())
        return (*grads, None)


def pallas_hsmm_log_z(log_obs, log_a, log_pi, log_dur):
    """Differentiable HSMM log-likelihood ``(B,)`` on the forward and
    backward sum kernels (their plain versions on CPU tensors)."""
    return _HSMMLogZ.apply(log_obs, log_a, log_pi, log_dur, None)


def _pallas_hsmm_lz_masked(log_obs, log_a, log_pi, log_dur, lengths):
    """Ragged twin of :func:`pallas_hsmm_log_z`; ``lengths`` is int32
    ``(B,)`` on the tensors' device."""
    return _HSMMLogZ.apply(log_obs, log_a, log_pi, log_dur, lengths)


def auto_hsmm_log_z(log_obs, log_a, log_pi, log_dur, lengths=None):
    """Differentiable HSMM log-likelihood ``(B,)``: the sum kernels with
    closed-form cotangents (:class:`_HSMMLogZ`) on the kernel route,
    ``core.hsmm_log_z`` elsewhere."""
    if not _hsmm_kernel_route(log_obs, log_dur):
        return core.hsmm_log_z(log_obs, log_a, log_pi, log_dur, lengths)
    args = _f32(log_obs, log_a, log_pi, log_dur)
    if lengths is None:
        return pallas_hsmm_log_z(*args)
    return _pallas_hsmm_lz_masked(*args, _lengths_on(lengths, log_obs.device))


def auto_hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths=None):
    """HSMM forward tables ``(log_alpha_star (B, T, S), log_z (B,))`` on
    the raw emissions: ``hsmm_smallk_forward`` on the kernel route (no
    gradient), ``core.hsmm_forward`` elsewhere."""
    if not _hsmm_kernel_route(log_obs, log_dur):
        return core.hsmm_forward(log_obs, log_a, log_pi, log_dur, lengths)
    with torch.no_grad():
        return hsmm_smallk_forward(*_f32(log_obs, log_a, log_pi, log_dur),
                                   _lengths_on(lengths, log_obs.device))


def auto_hsmm_posteriors(log_obs, log_a, log_pi, log_dur, lengths=None) -> dict:
    """Exact HSMM posteriors (``gamma``, ``segment_end``,
    ``segment_start``, ``log_z``; see ``core.hsmm_posteriors``). On the
    kernel route one ``hsmm_smallk_fb`` launch, ragged or not, on
    max-shifted emissions, then ``core.hsmm_posteriors_from_tables``;
    the shift's sum is added back to ``log_z``. The kernel route records
    no gradient."""
    if not _hsmm_kernel_route(log_obs, log_dur):
        return core.hsmm_posteriors(log_obs, log_a, log_pi, log_dur, lengths)
    with torch.no_grad():
        lo, la, lp, ld = _f32(log_obs, log_a, log_pi, log_dur)
        ln = _lengths_on(lengths, lo.device)
        shift = _frame_shift(lo, ln)
        alpha, lz_hat, bstar, bstart = hsmm_smallk_fb((lo - shift).contiguous(), la, lp, ld, ln)
        post = core.hsmm_posteriors_from_tables(la, lp, alpha, bstar, bstart, lz_hat, ln)
        post["log_z"] = lz_hat + shift.sum(dim=(1, 2))
    return post


def auto_hsmm_viterbi(log_obs, log_a, log_pi, log_dur, lengths=None):
    """HSMM Viterbi segmentation ``(states (B, T) int32, score (B,))``:
    ``hsmm_smallk_viterbi`` on the kernel route, ``core.hsmm_viterbi``
    elsewhere. Paths and scores are identical on both, tie-breaks
    included."""
    if not _hsmm_kernel_route(log_obs, log_dur):
        return core.hsmm_viterbi(log_obs, log_a, log_pi, log_dur, lengths)
    with torch.no_grad():
        return hsmm_smallk_viterbi(*_f32(log_obs, log_a, log_pi, log_dur),
                                   _lengths_on(lengths, log_obs.device))


# -- streaming ------------------------------------------------------------------


def auto_greedy_chunk(log_a, log_obs, n_valid, carry):
    """Greedy chunk decode ``((prev, has_prev), states (T,), log-scores
    (T,))``: ``greedy_chunk`` on CUDA tensors inside its envelope, the
    plain version elsewhere (larger shapes on the tensors' own device)."""
    T, S = log_obs.shape
    if log_obs.device.type == "cpu" or not stream_chunk_supported(S, T):
        return greedy_chunk_reference(log_a, log_obs, n_valid, carry)
    return greedy_chunk(*_f32(log_a, log_obs), n_valid, carry)


def auto_beam_chunk_multi(log_a, log_obs, n_valid, carry):
    """Beam chunk decode of ``(N, T, S)`` log-obs, returning the raw
    carry: ``beam_chunk_multi`` on CUDA tensors inside its envelope, the
    plain version elsewhere (larger shapes on the tensors' own device)."""
    N, T, S = log_obs.shape
    W, H = carry[2].shape[1], carry[2].shape[2]
    if log_obs.device.type == "cpu" or not multi_stream_supported(N, S, T, W, H):
        return beam_chunk_multi_reference(log_a, log_obs, n_valid, carry)
    return beam_chunk_multi(*_f32(log_a, log_obs), n_valid,
                            (carry[0].float().contiguous(), *carry[1:]))
