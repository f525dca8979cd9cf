"""Hand-written CUDA kernels for the hot HMM ops, and their dispatch.

Port of ``pytorch_hmm_tpu/ops/__init__.py``. The device decides the
path, as the backend does in the JAX package:

* CUDA tensors with K ≤ 32 run the small-K kernels: ``emit.diag_quadratic``
  for diag/tied emissions (``emit.diag_gmm_log_probs``, its mixture mode,
  for a GMM decode's state scores), ``emit_mlp.fused_gaussian_emission`` for the
  neural gaussian head, ``smallk.smallk_viterbi`` for decode,
  ``hsmm_smallk`` (forward and backward sum recursions at D = 1) for the
  likelihood and its gradient, ``fbsum.fbsum_smallk`` for posteriors and
  the ragged likelihood. Time-varying ``(B, T, K, K)`` transitions (the
  neural HMMs'), which the JAX package sends to its XLA scans, run the
  time-varying modes of ``smallk_viterbi`` and ``fbsum_smallk``, the
  likelihood too. Every K ≤ 32 goes to them at any T, ragged or not: the
  TPU kernels' VMEM gates (fbsum's 16 states and T < 1024) are TPU
  matters.
* CUDA tensors with 33 ≤ K ≤ 1024 and static ``(K, K)`` transitions run
  the general-K kernels of ``scan`` (rows 8, 9 and 13 of the JAX
  package's kernels): ``pallas_forward`` for alpha and the likelihood,
  ``pallas_backward`` for beta and the likelihood's gradient (with the
  transition statistic as the product ``core.xi_sum``, no ``(B, T, K,
  K)`` table), ``pallas_viterbi`` for decode. Diag GMM decode inside the
  JAX fused kernel's envelope (S ≤ 128, ``next_pow2(C) · ceil8(S) ≤
  128``) runs ``fused.fused_gmm_viterbi``.
* Long sequences (T ≥ 1024, unragged, static finite transitions, K ≤
  128) run the prob-space kernels of ``scan`` (rows 10-12), as the JAX
  package's ``_prob_ok`` gate sends them: ``pallas_forward_prob`` for
  ``auto_forward`` and a likelihood that records no gradient, and
  ``pallas_fb_prob`` for the differentiable likelihood (32 < K) and for
  ``auto_forward_backward`` (any K ≤ 128, ahead of ``fbsum_smallk``);
  see :func:`_sum_route`.
* Cases the JAX package has no TPU kernel for either (K > 1024, or
  time-varying transitions with K > 32) run the plain ``core`` on the
  tensors' own device.
* The duration models' segment DP (``auto_hsmm_viterbi``,
  ``auto_hsmm_log_z``, ``auto_hsmm_posteriors``): CUDA tensors with
  S ≤ 32 states and D ≤ 256 durations run the ``hsmm_smallk`` kernels,
  the sum chains on max-shifted emissions, and the likelihood's
  cotangents in one more kernel (``hsmm_table_grads``, which the JAX
  package leaves to XLA). Larger shapes, which the JAX
  package never gives a kernel either, run the plain ``core.hsmm_*`` on
  the tensors' own device.
* The streaming chunk decoders (``auto_greedy_chunk``,
  ``auto_beam_chunk_multi``): CUDA tensors inside the JAX kernels'
  envelope (S ≤ 128, W ≤ min(8, S), T and H ≤ 1024; any number of
  streams) run ``stream.greedy_chunk`` and ``stream_multi.beam_chunk_multi``.
  Larger shapes, which the JAX package sends to its XLA scan on every
  backend, run the plain versions on the tensors' own device.
* The CTC lattice chains (``ctc_kernel``, called by ``alignment.ctc``):
  CUDA tensors with S ≤ 2048 lattice positions and B ≤ 256 rows, at any
  T, run ``ctc_lattice_forward`` / ``ctc_lattice_backward`` and
  ``ctc_lattice_viterbi`` (choices resident) or
  ``ctc_lattice_viterbi_wide`` (choices streamed); larger lattices run
  the plain scans on the card.
* DTW (``dtw``, called by ``alignment.dtw``): CUDA tensors with N ≤ 4096
  rows and M ≤ 65536 columns run ``pallas_dtw``, the wavefront and
  backtrace in one launch; larger matrices run the plain wavefront on the
  card (the reference's XLA scan on every backend).
* The neural transition encoder's self-attention
  (``attention.masked_attention``, which the JAX package leaves to XLA):
  CUDA tensors run ``scaled_dot_product_attention`` pinned to its
  memory-efficient kernels, the padded keys masked by ``lengths``, or
  raise; CPU tensors run the masked einsums.
* Large-state scoring (``bigk.bigk_log_likelihood``, a public op with no
  caller in the package): CUDA tensors with K ≤ 1024, B ≤ 4096 and T a
  multiple of ``t_chunk`` run its bf16 tensor-core chain; other T take
  ``pallas_forward``'s log Z, as the reference does.
* CPU tensors run the plain torch versions (``core``).

A shape a kernel takes never lands on a plain path because a build or
launch failed: that raises. Kernel launches record no gradient: the
likelihood runs them inside autograd Functions with closed-form
backwards; posteriors and decodes of tensors that require a gradient
raise on CUDA (the JAX kernels have no VJP either), and differentiate
through the plain ``core`` on CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import core
from ..trace import span
from .attention import masked_attention, masked_attention_reference
from .bigk import bigk_log_likelihood, bigk_log_likelihood_reference, bigk_supported
from .ctc_kernel import (
    ctc_lattice_backward,
    ctc_lattice_backward_reference,
    ctc_lattice_forward,
    ctc_lattice_forward_reference,
    ctc_lattice_supported,
    ctc_lattice_viterbi,
    ctc_lattice_viterbi_reference,
    ctc_lattice_viterbi_wide,
    ctc_viterbi_kernel_supported,
    ctc_viterbi_wide_supported,
)
from .dtw import pallas_dtw, pallas_dtw_reference, pallas_dtw_supported
from .emit import diag_quadratic, diag_quadratic_reference
from .emit_mlp import (
    fused_emission_supported,
    fused_gaussian_emission,
    fused_gaussian_emission_reference,
)
from .fbsum import fbsum_smallk, fbsum_smallk_reference, fbsum_supported
from .fused import fused_gmm_supported, fused_gmm_viterbi, fused_gmm_viterbi_reference
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
    hsmm_table_grads,
)
from .scan import (
    MAX_K,
    PROB_MAX_K,
    pallas_backward,
    pallas_backward_prob,
    pallas_backward_prob_reference,
    pallas_backward_reference,
    pallas_fb_prob,
    pallas_fb_prob_reference,
    pallas_fb_prob_split,
    pallas_forward,
    pallas_forward_prob,
    pallas_forward_prob_reference,
    pallas_forward_reference,
    pallas_viterbi,
    pallas_viterbi_reference,
    prob_supported,
    scan_supported,
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
    "masked_attention",
    "masked_attention_reference",
    "bigk_log_likelihood",
    "bigk_log_likelihood_reference",
    "bigk_supported",
    "pallas_dtw",
    "pallas_dtw_reference",
    "pallas_dtw_supported",
    "ctc_lattice_backward",
    "ctc_lattice_backward_reference",
    "ctc_lattice_forward",
    "ctc_lattice_forward_reference",
    "ctc_lattice_supported",
    "ctc_lattice_viterbi",
    "ctc_lattice_viterbi_reference",
    "ctc_lattice_viterbi_wide",
    "ctc_viterbi_kernel_supported",
    "ctc_viterbi_wide_supported",
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
    "fused_gmm_supported",
    "fused_gmm_viterbi",
    "fused_gmm_viterbi_reference",
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
    "hsmm_table_grads",
    "MAX_DURATION",
    "MAX_K",
    "PROB_MAX_K",
    "PROB_MIN_T",
    "pallas_backward",
    "pallas_backward_prob",
    "pallas_backward_prob_reference",
    "pallas_backward_reference",
    "pallas_fb_prob",
    "pallas_fb_prob_reference",
    "pallas_fb_prob_split",
    "pallas_forward",
    "pallas_forward_prob",
    "pallas_forward_prob_reference",
    "pallas_forward_reference",
    "pallas_viterbi",
    "pallas_viterbi_reference",
    "prob_supported",
    "scan_supported",
    "smallk_viterbi",
    "smallk_viterbi_reference",
    "smallk_supported",
    "MAX_SMALLK",
]


# From this many frames on, unragged problems with finite static
# transitions take the prob-space kernels (the JAX package's
# ``_PROB_FWD_MIN_T``).
PROB_MIN_T = 1024


def _sum_route(log_obs: torch.Tensor, log_a: torch.Tensor, lengths=None,
               posteriors: bool = False) -> str:
    """The sum-recursion path of a problem off the CPU:

    * ``"prob"``: the prob-space rows 10-12, under the JAX package's gate
      (``_prob_ok``): unragged, static ``(K, K)`` ``log_a`` with every
      entry finite, T ≥ ``PROB_MIN_T``, 32 < K ≤ 128; with ``posteriors``
      (``auto_forward_backward``) any K ≤ 128, as the reference takes
      ``pallas_fb_prob`` there ahead of ``fbsum_smallk``. A ``-inf``
      entry keeps the problem on rows 8/9 (or the small-K kernels): hard
      zeros with mismatched emissions can underflow the scaled chain
      within one rescale interval;
    * ``"smallk"`` (K ≤ 32, static or time-varying);
    * ``"scan"`` (33 ≤ K ≤ 1024, static);
    * ``"plain"`` (no kernel in either package: ``core`` on the tensors'
      device).

    The finiteness test reads one flag back to the host: a device sync
    per call that gets that far. The reference also admits a traced
    ``log_a`` from T ≥ 4096 without inspecting it
    (``_PROB_FWD_UNVERIFIED_MIN_T``); torch tensors are never traced, so
    the port always inspects."""
    B, T, K = log_obs.shape
    static = log_a.ndim == 2
    if (static and lengths is None and T >= PROB_MIN_T and prob_supported(K)
            and (posteriors or K > MAX_SMALLK) and _finite(log_a)):
        return "prob"
    if fbsum_supported(K, B):
        return "smallk"
    if static and scan_supported(K):
        return "scan"
    return "plain"


def _finite(log_a: torch.Tensor) -> bool:
    """Every transition finite: one flag read back to the host."""
    return bool(torch.isfinite(log_a).all())


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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


def _frame_posteriors(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``log γ`` normalized per frame, ``alpha + beta - logsumexp_j(alpha +
    beta)``: equal to ``alpha + beta - log Z`` in exact arithmetic, but
    free of the rounding that f32 alpha and beta accumulate over T
    frames, which is common to a frame's states (5e-3 in γ at K=64,
    T=1000 with ``log Z``; 1e-12 per frame)."""
    lg = alpha + beta
    return lg - core.logsumexp(lg, dim=-1, keepdim=True)


class _LogLikelihood(torch.autograd.Function):
    """``log Z (B,)`` with the closed-form posterior gradients
    (``∂ log Z/∂ log_obs = γ``, ``∂/∂ log_a = Σ_t ξ_t``,
    ``∂/∂ log_pi = γ_0``), static transitions, unragged, on the sum
    ``route`` of :func:`_sum_route`. ``"prob"``: one ``pallas_fb_prob``
    launch gives alpha and beta in the forward pass, as the JAX package's
    VJP does in that envelope (the backward pass always needs beta), as
    tables split from their per-frame shifts; ``"scan"``:
    ``pallas_forward``, then ``pallas_backward`` in the backward pass;
    ``"smallk"``: the D = 1 forward and backward sum kernels. Then ``γ``
    and the ξ sum in plain torch (XLA in the JAX package):
    ``core.fb.xi_expectations`` at K ≤ 32, the product ``core.fb.xi_sum``
    above. The chains run on max-shifted emissions (:func:`_frame_shift`),
    which the shift cancels out of every posterior, and γ is normalized
    per frame (:func:`_frame_posteriors`)."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi, route):
        shift = _frame_shift(log_obs)
        lo_hat = (log_obs - shift).contiguous()
        beta = ()
        if route == "prob":
            # Tables relative to per-frame constants, which the per-frame
            # normalizations of γ and ξ never see (pallas_fb_prob_split).
            alpha_hat, alpha_shift, beta_hat, _ = pallas_fb_prob_split(lo_hat, log_a, log_pi)
            lz_hat = torch.logsumexp(alpha_hat[:, -1], dim=-1) + alpha_shift[:, -1]
            beta = (beta_hat,)
        elif route == "scan":
            alpha_hat, lz_hat = pallas_forward(lo_hat, log_a, log_pi)
        else:
            alpha_hat, lz_hat = hsmm_smallk_forward(lo_hat, log_a, log_pi,
                                                    _unit_durations(log_obs))
        ctx.route = route
        ctx.save_for_backward(lo_hat, log_a, alpha_hat, lz_hat, *beta)
        return lz_hat + shift.sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        lo_hat, log_a, alpha_hat, lz_hat, *beta = ctx.saved_tensors
        small = ctx.route == "smallk"
        if beta:
            beta_hat = beta[0]
        elif small:
            beta_hat = hsmm_smallk_backward(lo_hat, log_a, _unit_durations(lo_hat))[0]
        else:
            beta_hat = pallas_backward(lo_hat, log_a)
        log_gamma = _frame_posteriors(alpha_hat, beta_hat)
        d_log_obs = g[:, None, None] * torch.exp(log_gamma)
        d_log_pi = torch.sum(g[:, None] * torch.exp(log_gamma[:, 0]), dim=0)
        if small:
            lxi = core.fb.xi_expectations(alpha_hat, beta_hat, lo_hat, log_a, lz_hat)
            d_log_a = torch.sum(g[:, None, None] * torch.exp(lxi), dim=0)
        else:
            d_log_a = core.fb.xi_sum(alpha_hat, beta_hat, lo_hat, log_a, weights=g)
        return d_log_obs, d_log_a, d_log_pi, None


class _FBLogLikelihood(torch.autograd.Function):
    """``log Z (B,)`` of ragged rows, time-varying ``(B, T, K, K)``
    transitions, or both, on the sum ``route`` of :func:`_sum_route`.
    ``"smallk"``: ``fbsum_smallk`` gives alpha and beta in one launch
    (the backward always needs beta); otherwise (K > 32, static):
    ``pallas_forward`` in the forward pass, ``pallas_backward`` in the
    backward, as the JAX package's ragged VJP does. The gradients are
    the posteriors of valid frames and of transitions that land inside
    each row (``t + 1 < lengths[b]``), zero elsewhere; for time-varying
    ``log_a`` the per-frame ξ ``(B, T, K, K)``, zero at ``t = 0``.
    Max-shifted as :class:`_LogLikelihood` is."""

    @staticmethod
    def forward(ctx, log_obs, log_a, log_pi, lengths, route):
        shift = _frame_shift(log_obs, lengths)
        lo_hat = (log_obs - shift).contiguous()
        ctx.small = route == "smallk"
        if ctx.small:
            alpha_hat, beta_hat, lz_hat = fbsum_smallk(lo_hat, log_a, log_pi, lengths)
            ctx.save_for_backward(lo_hat, log_a, lengths, alpha_hat, lz_hat, beta_hat)
        else:
            alpha_hat, lz_hat = pallas_forward(lo_hat, log_a, log_pi, lengths)
            ctx.save_for_backward(lo_hat, log_a, lengths, alpha_hat, lz_hat)
        return lz_hat + shift.sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        with span("ops.fb_log_likelihood.backward"):
            lo_hat, log_a, lengths, alpha_hat, lz_hat, *beta = ctx.saved_tensors
            beta_hat = beta[0] if beta else pallas_backward(lo_hat, log_a, lengths)
            T = lo_hat.shape[1]
            tv = log_a.ndim == 4
            log_gamma = _frame_posteriors(alpha_hat, beta_hat)
            gamma = torch.exp(log_gamma)
            if lengths is not None:
                gamma = torch.where(_valid_frames(lengths, T)[..., None], gamma, 0.0)
            d_log_obs = g[:, None, None] * gamma
            d_log_pi = torch.sum(g[:, None] * torch.exp(log_gamma[:, 0]), dim=0)
            if not ctx.small:
                d_log_a = core.fb.xi_sum(alpha_hat, beta_hat, lo_hat, log_a, weights=g,
                                         lengths=lengths)
                return d_log_obs, d_log_a, d_log_pi, None, None
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
            return d_log_obs, d_log_a, d_log_pi, None, None


def pallas_log_likelihood(log_obs, log_a, log_pi):
    """Differentiable sequence log-likelihood ``(B,)`` on the forward and
    backward sum kernels of the problem's route (:func:`_sum_route`;
    their plain versions on CPU tensors)."""
    return _LogLikelihood.apply(log_obs, log_a, log_pi, _sum_route(log_obs, log_a))


def _pallas_ll_masked(log_obs, log_a, log_pi, lengths, route=None):
    """Ragged or time-varying twin of :func:`pallas_log_likelihood`;
    ``lengths`` is None or int32 ``(B,)`` on the tensors' device;
    ``route`` is :func:`_sum_route`'s unless given."""
    if route is None:
        route = _sum_route(log_obs, log_a, lengths)
    return _FBLogLikelihood.apply(log_obs, log_a, log_pi, lengths, route)


def auto_log_likelihood(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """Differentiable ``log Z (B,)``: the sum kernels with closed-form
    posterior gradients off the CPU (:class:`_LogLikelihood` for static
    unragged problems, :class:`_FBLogLikelihood` for ragged or
    time-varying ones), autograd through the plain
    ``core.log_likelihood`` scan on CPU and where no kernel exists. On
    the prob route a call that records no gradient (grad mode off, or no
    input requires one) runs ``pallas_forward_prob`` alone, as the JAX
    package's primal does."""
    if log_obs.device.type == "cpu":
        return core.log_likelihood(log_obs, log_a, log_pi, lengths)
    route = _sum_route(log_obs, log_a, lengths)
    if route == "plain":
        return core.log_likelihood(log_obs, log_a, log_pi, lengths)
    args = _f32(log_obs, log_a, log_pi)
    if route == "prob" and not _records_grad(log_obs, log_a, log_pi):
        return pallas_forward_prob(*args)[1]
    if lengths is None and log_a.ndim == 2:
        return _LogLikelihood.apply(*args, route)
    return _pallas_ll_masked(*args, _lengths_on(lengths, log_obs.device), route)


def auto_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(log_alpha, log_z)``: off the CPU the D = 1 forward sum kernel
    (K ≤ 32; for time-varying transitions alpha and log Z of one
    ``fbsum_smallk`` launch), ``pallas_forward_prob`` on the prob route
    (:func:`_sum_route`) or ``pallas_forward`` (33 ≤ K ≤ 1024);
    ``core.forward_log`` on CPU and where no kernel exists. Past each
    row's end alpha holds its final valid value, as ``core`` freezes it."""
    route = "plain" if log_obs.device.type == "cpu" else _sum_route(log_obs, log_a, lengths)
    if route == "plain":
        return core.forward_log(log_obs, log_a, log_pi, lengths)
    if route == "prob":
        return pallas_forward_prob(*_f32(log_obs, log_a, log_pi))
    ln = _lengths_on(lengths, log_obs.device)
    if route == "scan":
        return pallas_forward(*_f32(log_obs, log_a, log_pi), ln)
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


def _shifted_forward_backward(log_obs, log_a, log_pi, lengths=None, route=None):
    """Alpha and beta on max-shifted emissions (:func:`_frame_shift`) on
    the posteriors' ``route`` (:func:`_sum_route` unless given): one
    ``pallas_fb_prob`` launch on ``"prob"``, one ``fbsum_smallk`` launch
    on ``"smallk"``, ``pallas_forward`` and ``pallas_backward`` on
    ``"scan"``; the cumulative shift is re-added to alpha, beta and log Z
    so the outputs stay raw. On ``"prob"`` the posteriors come from the
    tables split from their per-frame shifts (``pallas_fb_prob_split``),
    and the raw tables are their sums."""
    if route is None:
        route = _sum_route(log_obs, log_a, lengths, posteriors=True)
    shift = _frame_shift(log_obs, lengths)
    lo_hat = (log_obs - shift).contiguous()
    if route == "prob":
        alpha_rel, alpha_shift, beta_rel, beta_shift = pallas_fb_prob_split(lo_hat, log_a, log_pi)
        log_gamma = _frame_posteriors(alpha_rel, beta_rel)
        alpha_hat = alpha_rel.add_(alpha_shift[..., None])      # in place: 1 GB at T=131072
        beta_hat = beta_rel.add_(beta_shift[..., None])
        lz_hat = torch.logsumexp(alpha_hat[:, -1], dim=-1)
    else:
        if route == "scan":
            alpha_hat, lz_hat = pallas_forward(lo_hat, log_a, log_pi, lengths)
            beta_hat = pallas_backward(lo_hat, log_a, lengths)
        else:
            alpha_hat, beta_hat, lz_hat = fbsum_smallk(lo_hat, log_a, log_pi, lengths)
        log_gamma = _frame_posteriors(alpha_hat, beta_hat)
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
    """``(log_gamma, log_alpha, log_beta, log_z)``: off the CPU the sum
    kernels on max-shifted emissions (``pallas_fb_prob`` on the prob
    route, any K ≤ 128; ``fbsum_smallk`` at K ≤ 32, static or
    time-varying; ``pallas_forward`` and ``pallas_backward`` at
    33 ≤ K ≤ 1024, static), ``core.forward_backward`` on CPU and where
    no kernel exists. The posterior normalization matches ``core``
    exactly. No gradient: CUDA tensors that require one raise."""
    if log_obs.device.type == "cpu":
        return core.forward_backward(log_obs, log_a, log_pi, lengths)
    route = _sum_route(log_obs, log_a, lengths, posteriors=True)
    if route == "plain":
        return core.forward_backward(log_obs, log_a, log_pi, lengths)
    return _shifted_forward_backward(*_f32(log_obs, log_a, log_pi),
                                     _lengths_on(lengths, log_obs.device), route)


def auto_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """``(states (B, T) int32, score (B,))``: off the CPU
    ``smallk_viterbi`` (K ≤ 32, static or time-varying transitions) or
    ``pallas_viterbi`` (33 ≤ K ≤ 1024, static); the plain ``core.viterbi``
    on CPU and where no kernel exists. Every route breaks ties alike;
    ``smallk_viterbi`` runs its chain bounded, so its paths can differ
    from the plain float32 chain's where two paths tie within that
    chain's rounding."""
    K = log_obs.shape[-1]
    dev = log_obs.device
    if dev.type != "cpu":
        if smallk_supported(K):
            return smallk_viterbi(*_f32(log_obs, log_a, log_pi), _lengths_on(lengths, dev))
        if log_a.ndim == 2 and scan_supported(K):
            return pallas_viterbi(*_f32(log_obs, log_a, log_pi), _lengths_on(lengths, dev))
    return core.viterbi(log_obs, log_a, log_pi, lengths)


def auto_gmm_viterbi(
    obs: torch.Tensor,
    means: torch.Tensor,
    cov_params: Optional[torch.Tensor] = None,
    log_w: Optional[torch.Tensor] = None,
    log_a: Optional[torch.Tensor] = None,
    log_pi: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    covariance_type: str = "diag",
    log_vars: Optional[torch.Tensor] = None,
):
    """GMM-HMM decode ``(states, score)`` — the decode path, in the JAX
    package's order: off the CPU, S ≤ 32 scores the emissions
    (``emissions.gmm_log_probs``: for diag and tied covariances the
    ``diag_quadratic`` kernel in its mixture mode, the logsumexp over
    components in its output stage) into ``smallk_viterbi``; diag covariance inside
    :func:`fused_gmm_supported` runs ``fused_gmm_viterbi`` (emission and
    trellis in one launch); everything else scores the emissions into
    :func:`auto_viterbi`. ``log_vars`` is the JAX package's older name of
    ``cov_params``, taken when ``cov_params`` is not given.
    """
    from ..emissions import gmm_log_probs

    if cov_params is None:
        cov_params = log_vars
    S, C = log_w.shape
    with span("ops.auto_gmm_viterbi"):
        if (obs.device.type != "cpu" and not smallk_supported(S) and covariance_type == "diag"
                and fused_gmm_supported(S, C, covariance_type)):
            return fused_gmm_viterbi(*_f32(obs, means, cov_params, log_w, log_a, log_pi),
                                     _lengths_on(lengths, obs.device))
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
    sum kernel; backward: the backward sum kernel, then the cotangents'
    kernel (:func:`hsmm_table_grads`). Both chains run on
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
        with span("ops.hsmm_log_z.backward"):
            lo_hat, log_a, log_pi, log_dur, lengths, alpha_hat, lz_hat = ctx.saved_tensors
            bstar, bstart = hsmm_smallk_backward(lo_hat, log_a, log_dur, lengths)
            grads = hsmm_table_grads(lo_hat, log_a, log_pi, log_dur, alpha_hat, bstar, bstart,
                                     lz_hat, lengths, g.contiguous())
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
    with span("ops.auto_hsmm_log_z"):
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
    with span("ops.auto_hsmm_viterbi"):
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
