"""CTC loss, forced alignment and segmentation on the blank-interleaved
label lattice.

Port of ``pytorch_hmm_tpu/alignment/ctc.py``. CTC runs as a log-semiring
recursion over the ``2U+1`` expanded lattice ``[blank, y_1, blank, ...,
y_U, blank]`` with a banded transition structure (stay / advance /
skip), vectorized over batch and lattice positions:

* :func:`ctc_forward_algorithm` / :func:`ctc_backward_algorithm`: exact
  alpha / beta;
* :func:`ctc_loss`: differentiable, through an autograd Function whose
  backward is the closed-form lattice posterior;
* :func:`ctc_alignment_path`: posterior-argmax alignment;
* :func:`ctc_viterbi_alignment` / :meth:`CTCAligner.align`: exact
  max-semiring forced alignment with backtrace;
* :meth:`CTCAligner.decode` / ``decode_batch``: batched greedy and
  fixed-width prefix beam search (``ctc_decode.py``); the numpy
  :func:`_prefix_beam_search` is the host oracle.

On CUDA tensors whose lattice fits the kernels' envelope (S ≤ 2048, B ≤
256, any T: ``ops.ctc_kernel.ctc_lattice_supported``) the recursions run
the hand kernels of ``csrc/ctc_lattice.cu``; other shapes on the card,
and every CPU tensor, run the plain scans here, which are the JAX
package's XLA scans. The free functions run on their inputs' device;
the aligner modules move their inputs to theirs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.semiring import logsumexp
from ..ops.ctc_kernel import (
    _down,
    _up,
    ctc_lattice_backward,
    ctc_lattice_forward,
    ctc_lattice_supported,
    ctc_lattice_viterbi,
    ctc_lattice_viterbi_wide,
    ctc_viterbi_kernel_supported,
)

__all__ = [
    "expand_targets_with_blank",
    "ctc_forward_algorithm",
    "ctc_backward_algorithm",
    "ctc_loss",
    "ctc_alignment_path",
    "ctc_viterbi_alignment",
    "CTCAligner",
    "CTCSegmentationAligner",
    "remove_ctc_blanks",
    "collapse_repeated_tokens",
    "ctc_decode_sequence",
]

_NEG = -1e30


def expand_targets_with_blank(targets: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """``(B, U)`` labels → ``(B, 2U+1)`` blank-interleaved lattice
    ``[blank, y_1, blank, y_2, ..., y_U, blank]``."""
    B, U = targets.shape
    out = torch.full((B, 2 * U + 1), blank_id, dtype=targets.dtype, device=targets.device)
    out[:, 1::2] = targets
    return out


def _lattice_masks(expanded: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Skip-transition permission per lattice position: a jump from s-2 is
    allowed when label(s) is not blank and differs from label(s-2)."""
    lbl_m2 = torch.cat([torch.full_like(expanded[:, :2], -1), expanded[:, :-2]], dim=1)
    return (expanded != blank_id) & (expanded != lbl_m2[:, : expanded.shape[1]])


def _gather_emissions(log_probs: torch.Tensor, expanded: torch.Tensor) -> torch.Tensor:
    """``lp[b, t, s] = log_probs[t, b, expanded[b, s]]``, ``(B, T, S)``.
    Clamped at ``-1e30`` first, as the JAX package's one-hot contraction
    does, so ``-inf`` logits land as the finite log(0) sentinel."""
    T, B, _ = log_probs.shape
    idx = expanded.long()[:, None, :].expand(B, T, expanded.shape[1])
    return torch.gather(log_probs.clamp_min(_NEG).transpose(0, 1), 2, idx)


def _tokens_at(expanded: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``expanded[b, positions[b, t]]``, ``(B, T)``."""
    return torch.gather(expanded, 1, positions.long())


def _use_ctc_kernels(lp: torch.Tensor) -> bool:
    """The lattice kernels take ``lp (B, T, S)`` on CUDA inside their
    envelope; anything else runs the plain scans on its device."""
    B, _, S = lp.shape
    return lp.device.type == "cuda" and ctc_lattice_supported(S, B)


def _lattice(log_probs, targets, input_lengths, target_lengths, blank_id):
    """Lengths on ``log_probs``' device and the lattice tables: ``(il, tl,
    expanded, skip_ok, valid_pos, lp)``."""
    dev = log_probs.device
    il = torch.as_tensor(input_lengths, device=dev).long()
    tl = torch.as_tensor(target_lengths, device=dev).long()
    expanded = expand_targets_with_blank(torch.as_tensor(targets, device=dev), blank_id)
    S = expanded.shape[1]
    skip_ok = _lattice_masks(expanded, blank_id)
    valid_pos = torch.arange(S, device=dev)[None, :] < (2 * tl[:, None] + 1)
    lp = _gather_emissions(log_probs, expanded)
    return il, tl, expanded, skip_ok, valid_pos, lp


def _initial_row(lp, valid_pos, tl):
    """Frame 0 of alpha / delta: the leading blank, and the first label
    where the target is not empty."""
    s_idx = torch.arange(lp.shape[2], device=lp.device)[None, :]
    first = lp[:, 0]
    a0 = torch.where(s_idx == 0, first, _NEG)
    a0 = torch.where((s_idx == 1) & (tl[:, None] > 0), first, a0)
    return torch.where(valid_pos, a0, _NEG)


def _masks(skip_ok, valid_pos, dtype):
    """The kernels' additive 0 / ``-1e30`` masks."""
    zero = torch.zeros((), dtype=dtype, device=skip_ok.device)
    return torch.where(skip_ok, zero, _NEG), torch.where(valid_pos, zero, _NEG)


def _ends(tl):
    return 2 * tl, (2 * tl - 1).clamp_min(0)


def _backward_rows(skip_ok, tl, dtype):
    """``(skip_fwd, bT)``: where a skip may leave position s (to s + 2),
    and beta at each row's final frame, 0 at the two exit positions."""
    S = skip_ok.shape[1]
    s_idx = torch.arange(S, device=skip_ok.device)[None, :]
    e1, e2 = _ends(tl)
    bT = torch.where((s_idx == e1[:, None]) | (s_idx == e2[:, None]),
                     torch.zeros((), dtype=dtype, device=skip_ok.device), _NEG)
    skip_fwd = torch.cat([skip_ok[:, 2:], torch.zeros_like(skip_ok[:, :2])], dim=1)[:, :S]
    return skip_fwd, bT


def ctc_forward_algorithm(log_probs: torch.Tensor, targets: torch.Tensor,
                          input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                          blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC forward pass.

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities (torch CTC layout).
        targets: ``(B, U)`` label ids (padded).
        input_lengths / target_lengths: ``(B,)`` valid lengths.

    Returns:
        ``(log_alpha (B, T, 2U+1), log_likelihood (B,))``; alpha is frozen
        past each row's length.
    """
    T = log_probs.shape[0]
    il, tl, _, skip_ok, valid_pos, lp = _lattice(
        log_probs, targets, input_lengths, target_lengths, blank_id)
    B, _, S = lp.shape
    a0 = _initial_row(lp, valid_pos, tl)
    if _use_ctc_kernels(lp):
        skip_add, vmask = _masks(skip_ok, valid_pos, lp.dtype)
        log_alpha = ctc_lattice_forward(lp, skip_add, vmask, a0, il)
    else:
        a, rows = a0, [a0]
        for t in range(1, T):
            skip = torch.where(skip_ok, _down(a, 2), _NEG)
            nxt = lp[:, t] + logsumexp(torch.stack([a, _down(a, 1), skip]), dim=0)
            nxt = torch.where(valid_pos, nxt, _NEG)
            a = torch.where((t < il)[:, None], nxt, a)
            rows.append(a)
        log_alpha = torch.stack(rows, dim=1)
    last_t = (il - 1).clamp(0, T - 1)
    last = log_alpha.gather(1, last_t[:, None, None].expand(B, 1, S))[:, 0]
    e1, e2 = _ends(tl)
    end1 = last.gather(1, e1[:, None])
    # An empty target has one exit position (the lone blank); both indices
    # resolve to it, so the duplicate is masked to avoid a + log 2.
    end2 = torch.where(tl[:, None] > 0, last.gather(1, e2[:, None]), _NEG)
    return log_alpha, logsumexp(torch.cat([end1, end2], dim=1), dim=1)


def ctc_backward_algorithm(log_probs: torch.Tensor, targets: torch.Tensor,
                           input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                           blank_id: int = 0) -> torch.Tensor:
    """CTC backward pass → ``log_beta (B, T, 2U+1)``: frames whose
    successor is at or past the row's end hold the terminal row (0 at the
    two exit positions)."""
    T = log_probs.shape[0]
    il, tl, _, skip_ok, valid_pos, lp = _lattice(
        log_probs, targets, input_lengths, target_lengths, blank_id)
    skip_fwd, bT = _backward_rows(skip_ok, tl, lp.dtype)
    if _use_ctc_kernels(lp):
        skip_add, vmask = _masks(skip_fwd, valid_pos, lp.dtype)
        return ctc_lattice_backward(lp, skip_add, vmask, bT, il)
    b, rows = bT, [bT] * T
    for t in range(T - 2, -1, -1):
        msg = b + lp[:, t + 1]
        skip = torch.where(skip_fwd, _up(msg, 2), _NEG)
        nxt = logsumexp(torch.stack([msg, _up(msg, 1), skip]), dim=0)
        nxt = torch.where(valid_pos, nxt, _NEG)
        b = torch.where((t + 1 < il)[:, None], nxt, bT)
        rows[t] = b
    return torch.stack(rows, dim=1)


class _CTCLogLikelihood(torch.autograd.Function):
    """Per-sequence CTC log-likelihood ``(B,)``. The backward is the
    closed form: the lattice posterior ``exp(alpha + beta - ll)`` on valid
    frames, summed onto the vocabulary by the expanded labels. One forward
    and one backward chain; no autograd through the recursion."""

    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths, blank_id):
        log_alpha, ll = ctc_forward_algorithm(log_probs, targets, input_lengths,
                                              target_lengths, blank_id)
        ctx.blank_id = blank_id
        ctx.save_for_backward(log_probs, targets, input_lengths, target_lengths, log_alpha, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        log_probs, targets, input_lengths, target_lengths, log_alpha, ll = ctx.saved_tensors
        T, B, C = log_probs.shape
        log_beta = ctc_backward_algorithm(log_probs, targets, input_lengths, target_lengths,
                                          ctx.blank_id)
        # beta excludes frame t's emission, so alpha + beta is the whole
        # path mass through position s at frame t.
        post = torch.exp(log_alpha + log_beta - ll[:, None, None])
        valid_t = torch.arange(T, device=post.device)[None, :, None] < input_lengths[:, None, None]
        post = torch.where(valid_t, post, torch.zeros((), dtype=post.dtype, device=post.device))
        expanded = expand_targets_with_blank(targets, ctx.blank_id).long()
        d_lp = torch.zeros((B, T, C), dtype=post.dtype, device=post.device)
        d_lp.scatter_add_(2, expanded[:, None, :].expand(B, T, expanded.shape[1]), post)
        return g[None, :, None] * d_lp.transpose(0, 1), None, None, None, None


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
             target_lengths: torch.Tensor, blank_id: int = 0,
             reduction: str = "mean") -> torch.Tensor:
    """Differentiable CTC loss on the lattice recursion (the hand kernels
    on CUDA), gradients from the closed-form posterior. ``reduction``:
    ``"mean"`` (each sequence's loss over its target length, at least 1,
    then the batch mean), ``"sum"``, anything else per sequence."""
    dev = log_probs.device
    il = torch.as_tensor(input_lengths, device=dev).long()
    tl = torch.as_tensor(target_lengths, device=dev).long()
    nll = -_CTCLogLikelihood.apply(log_probs, torch.as_tensor(targets, device=dev), il, tl,
                                   blank_id)
    if reduction == "mean":
        return torch.mean(nll / tl.clamp_min(1))
    if reduction == "sum":
        return torch.sum(nll)
    return nll


def ctc_viterbi_alignment(log_probs: torch.Tensor, targets: torch.Tensor,
                          input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                          blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact forced alignment: max-semiring lattice DP and backtrace.

    Returns ``(alignment (B, T) token ids, score (B,))``, the most likely
    frame-level label sequence consistent with the target; frames past
    ``input_lengths`` repeat the final label. Ties go stay > advance >
    skip. On CUDA in the envelope: the resident-choice kernel while one
    sequence's choice table fits shared memory
    (``ops.ctc_kernel.ctc_viterbi_kernel_supported``), else the streamed
    one, at any T.
    """
    T = log_probs.shape[0]
    il, tl, expanded, skip_ok, valid_pos, lp = _lattice(
        log_probs, targets, input_lengths, target_lengths, blank_id)
    B, _, S = lp.shape
    d = _initial_row(lp, valid_pos, tl)
    end1, end2 = _ends(tl)
    if _use_ctc_kernels(lp):
        # The kernels return no gradient: the score is a plain value here.
        skip_add, vmask = _masks(skip_ok, valid_pos, lp.dtype)
        fn = ctc_lattice_viterbi if ctc_viterbi_kernel_supported(T, B, S) else ctc_lattice_viterbi_wide
        positions, score = fn(lp.detach(), skip_add, vmask, d.detach(), il, end1, end2)
        return _tokens_at(expanded, positions), score
    choices = []
    for t in range(1, T):
        adv, skip = _down(d, 1), torch.where(skip_ok, _down(d, 2), _NEG)
        best = torch.maximum(torch.maximum(d, adv), skip)
        # First of ties: stay > advance > skip (jnp.argmax's order).
        choice = torch.where(best == d, 0, torch.where(best == adv, 1, 2))
        nxt = torch.where(valid_pos, lp[:, t] + best, _NEG)
        frozen = (t >= il)[:, None]
        d = torch.where(frozen, d, nxt)
        choices.append(torch.where(frozen, 0, choice))
    v1, v2 = d.gather(1, end1[:, None])[:, 0], d.gather(1, end2[:, None])[:, 0]
    pos = torch.where(v1 >= v2, end1, end2)
    out = [pos]
    for t in range(T - 1, 0, -1):
        # Frame t's choice gives the position at t - 1. A step below 0
        # (paths of -1e30 scores only) stops at 0, as the kernels' does.
        pos = (pos - choices[t - 1].gather(1, pos[:, None])[:, 0]).clamp_min(0)
        out.append(pos)
    positions = torch.stack(out[::-1], dim=1)
    return _tokens_at(expanded, positions), torch.maximum(v1, v2)


def _rows(x: torch.Tensor, lengths) -> List[torch.Tensor]:
    lens = torch.as_tensor(lengths).tolist()
    return [x[b, : lens[b]] for b in range(x.shape[0])]


def ctc_alignment_path(log_probs: torch.Tensor, targets: torch.Tensor,
                       input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                       blank_id: int = 0) -> List[torch.Tensor]:
    """Posterior-argmax alignment: per-sequence token ids at the lattice
    position of largest ``alpha + beta`` in each frame, trimmed to
    ``input_lengths``."""
    with torch.no_grad():
        log_alpha, _ = ctc_forward_algorithm(log_probs, targets, input_lengths,
                                             target_lengths, blank_id)
        log_beta = ctc_backward_algorithm(log_probs, targets, input_lengths, target_lengths,
                                          blank_id)
    expanded = expand_targets_with_blank(torch.as_tensor(targets, device=log_probs.device),
                                         blank_id)
    tokens = _tokens_at(expanded, torch.argmax(log_alpha + log_beta, dim=-1))
    return _rows(tokens, input_lengths)


# ---------------------------------------------------------------------------
# Decode utilities
# ---------------------------------------------------------------------------

def remove_ctc_blanks(sequence: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    seq = torch.as_tensor(sequence)
    return seq[seq != blank_id]


def collapse_repeated_tokens(sequence: torch.Tensor) -> torch.Tensor:
    seq = torch.as_tensor(sequence)
    if seq.numel() == 0:
        return seq
    keep = torch.cat([torch.ones_like(seq[:1], dtype=torch.bool), seq[1:] != seq[:-1]])
    return seq[keep]


def ctc_decode_sequence(sequence: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Collapse repeats, then drop blanks (the standard CTC decoding rule)."""
    return remove_ctc_blanks(collapse_repeated_tokens(sequence), blank_id)


# ---------------------------------------------------------------------------
# Aligner modules
# ---------------------------------------------------------------------------

class CTCAligner(nn.Module):
    """CTC loss, decode and forced alignment. It has no parameters; its
    inputs move to its device (the CUDA device unless ``device`` names
    another; ``.to()`` moves it)."""

    def __init__(self, num_classes: int, blank_id: int = 0, reduction: str = "mean",
                 device="cuda"):
        super().__init__()
        self.num_classes = num_classes
        self.blank_id = blank_id
        self.reduction = reduction
        self.register_buffer("_anchor", torch.empty(0, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _on(self, *xs):
        return [torch.as_tensor(x).to(self.device) for x in xs]

    def forward(self, log_probs, targets, input_lengths, target_lengths) -> torch.Tensor:
        """CTC loss with the module's ``reduction``."""
        return ctc_loss(*self._on(log_probs, targets, input_lengths, target_lengths),
                        self.blank_id, self.reduction)

    def decode(self, log_probs: torch.Tensor, input_lengths: torch.Tensor,
               beam_width: int = 1) -> List[torch.Tensor]:
        """Greedy (``beam_width == 1``) or prefix-beam-search decoding:
        per-sequence token ids. :meth:`decode_batch` keeps the padded
        batch on the device."""
        tokens, out_lens = self.decode_batch(log_probs, input_lengths, beam_width)
        return _rows(tokens, out_lens.cpu())

    def decode_batch(self, log_probs: torch.Tensor, input_lengths: torch.Tensor,
                     beam_width: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched decode on the device: ``(tokens (B, L), out_lengths
        (B,))`` padded with ``blank_id``."""
        from .ctc_decode import beam_search_decode_batch, greedy_decode_batch

        log_probs, input_lengths = self._on(log_probs, input_lengths)
        if beam_width == 1:
            return greedy_decode_batch(log_probs, input_lengths, self.blank_id)
        return beam_search_decode_batch(log_probs, input_lengths, beam_width, self.blank_id)

    def align(self, log_probs, targets, input_lengths, target_lengths) -> List[torch.Tensor]:
        """Forced alignment by exact lattice Viterbi: per-sequence
        frame-level token ids, trimmed to ``input_lengths``."""
        alignment, _ = ctc_viterbi_alignment(
            *self._on(log_probs, targets, input_lengths, target_lengths), self.blank_id)
        return _rows(alignment, torch.as_tensor(input_lengths).cpu())


def _prefix_beam_search(lp: np.ndarray, beam_width: int, blank_id: int) -> np.ndarray:
    """Standard CTC prefix beam search over one utterance ``(T, C)``, on
    the host (the test oracle of ``ctc_decode.beam_search_decode_batch``)."""
    # Each prefix maps to (log p ending in blank, log p ending in non-blank).
    beams = {(): (0.0, -np.inf)}
    for t in range(lp.shape[0]):
        new: dict = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (-np.inf, -np.inf))
            new[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            p_tot = np.logaddexp(pb, pnb)
            # blank extends the same prefix
            add(prefix, p_tot + lp[t, blank_id], -np.inf)
            for c in range(lp.shape[1]):
                if c == blank_id:
                    continue
                p = lp[t, c]
                if prefix and prefix[-1] == c:
                    # a repeat: the same prefix (no blank between) ...
                    add(prefix, -np.inf, pnb + p)
                    # ... or a new token after a blank
                    add(prefix + (c,), -np.inf, pb + p)
                else:
                    add(prefix + (c,), -np.inf, p_tot + p)
        beams = dict(sorted(new.items(), key=lambda kv: -np.logaddexp(*kv[1]))[:beam_width])
    best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0]
    return np.asarray(best, dtype=np.int32)


class CTCSegmentationAligner(CTCAligner):
    """Long-audio segmentation and per-segment transcript assignment."""

    def __init__(self, num_classes: int, min_segment_length: int = 50,
                 max_segment_length: int = 1000, blank_id: int = 0, reduction: str = "mean",
                 device="cuda"):
        super().__init__(num_classes, blank_id, reduction, device)
        self.min_segment_length = min_segment_length
        self.max_segment_length = max_segment_length

    def segment_and_align(self, log_probs: torch.Tensor, full_transcript: torch.Tensor,
                          segment_boundaries: Optional[torch.Tensor] = None,
                          ) -> List[Tuple[torch.Tensor, torch.Tensor, int, int]]:
        """Split ``(T, C)`` log-probs into segments and assign transcript
        spans proportionally: ``[(segment_log_probs, segment_text, start,
        end), ...]``."""
        log_probs, full_transcript = self._on(log_probs, full_transcript)
        T = log_probs.shape[0]
        if segment_boundaries is None:
            segment_boundaries = self._detect_segment_boundaries(log_probs, full_transcript)
        bounds = [int(x) for x in torch.as_tensor(segment_boundaries).tolist()]
        if not bounds or bounds[-1] != T:
            bounds = bounds + [T]
        U = full_transcript.shape[0]
        segments = []
        prev = 0
        for boundary in bounds:
            # Spans below the minimum merge into the next segment (prev only
            # advances on emission), so every frame lands in one segment and
            # the proportional transcript split stays a partition.
            if boundary - prev >= self.min_segment_length:
                lo, hi = int(round(prev * U / T)), int(round(boundary * U / T))
                segments.append((log_probs[prev:boundary], full_transcript[lo:hi], prev, boundary))
                prev = boundary
        if prev < T:
            # A short trailing span extends the final segment.
            if segments:
                start = segments[-1][2]
                lo = int(round(start * U / T))
                segments[-1] = (log_probs[start:T], full_transcript[lo:U], start, T)
            else:
                segments.append((log_probs[0:T], full_transcript[0:U], 0, T))
        return segments

    def _detect_segment_boundaries(self, log_probs: torch.Tensor,
                                   transcript: torch.Tensor) -> torch.Tensor:
        """Fixed-length segmentation."""
        T = log_probs.shape[0]
        bounds = torch.arange(0, T, self.max_segment_length)
        return bounds[bounds > 0] if bounds.shape[0] > 1 else torch.as_tensor([T])
