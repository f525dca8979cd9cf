"""Self-attention over each row's valid frames, fused on the card.

The transition encoder of ``models/neural.py`` (``NeuralTransitionModel``
with ``model_type="transformer"``) runs ``softmax(q·kᵀ + mask)·v`` once a
block. The JAX package runs it as plain XLA, two einsums around a
softmax; at a training batch (B=512, T=1000, 8 heads) each of those
``(B, H, T, T)`` tensors holds 16.4 GB in float32, and autograd keeps them
for every block.

:func:`masked_attention` is the one call site. Three routes, chosen by
the input alone:

* CUDA tensors of a ragged batch (``lengths`` with a row shorter than T)
  run the memory-efficient kernels' cumulative-length entry
  (``aten._efficient_attention_forward`` / ``_backward`` with
  ``cu_seqlens``, in :class:`_RaggedAttention`): the valid frames of every
  row are gathered back to back into ``(1, N, H, d)``, each row attends
  within its own frames, and the output is scattered back. The kernels
  visit only the tiles of each row's ``L × L`` square, not the padded
  ``T × T`` one, and load no mask.
* CUDA tensors without ``lengths``, or with every row full, run
  ``torch.nn.functional.scaled_dot_product_attention`` pinned to the same
  memory-efficient backend (``sdpa_kernel``), unmasked.

  On both CUDA routes the logits never leave the kernel, forward or
  backward, and the float32 kernels hold float32 accuracy, well inside
  TF32's (``tests/test_torch_neural_transformer_card.py``). Where the
  kernels refuse the problem (float64, say), the call raises; it never
  falls back to a path that builds ``B·H·T·T`` elements.
* CPU tensors run :func:`masked_attention_reference`, the two einsums,
  with the padded keys set to ``-inf`` before the softmax.

With ``lengths`` row ``b`` attends to its keys ``0 .. lengths[b] - 1``
alone, so what a valid query gives does not depend on the row's padding,
and its padded queries hold 0 and pass no gradient, on every route. A row
keeps its first frame whatever its length, so no softmax is empty and
nothing turns into NaN.

:func:`ragged_rows` reads ``lengths`` back once (one sync) and builds what
the ragged route needs; an encoder builds it once for all its blocks and
passes it in place of ``lengths``.

Counters (module globals, read by tests and ``chip_smoke.py``; none
syncs): ``attention_calls``, the calls; ``attention_masked_keys``, the
padded keys masked, summed over rows and calls; ``attention_varlen_calls``,
the calls that took the cumulative-length route; and
``attention_pairs_skipped``, over those calls, the (query, key) pairs of
the padded square outside every row's own, ``B·T² − Σ L²``, one head's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..trace import span

__all__ = ["RaggedRows", "masked_attention", "masked_attention_reference", "ragged_rows"]

attention_calls = 0
attention_masked_keys = 0
attention_varlen_calls = 0
attention_pairs_skipped = 0


class RaggedRows(NamedTuple):
    """The valid frames of a ragged ``(B, T)`` batch, each row's length
    clamped to ``1 .. T``: ``frames`` (N), ``max_seqlen`` and
    ``pairs_skipped`` (``B·T² − Σ L²``) host ints; ``valid (B, T)`` bool;
    ``index (N,)`` the flat ``b·T + t`` of each valid frame in order;
    ``cu_seqlens (B + 1,)`` int32, each row's first packed frame."""

    shape: Tuple[int, int]
    frames: int
    max_seqlen: int
    pairs_skipped: int
    valid: torch.Tensor
    index: torch.Tensor
    cu_seqlens: torch.Tensor


def ragged_rows(lengths, B: int, T: int, device) -> Optional[RaggedRows]:
    """:class:`RaggedRows` of ``lengths (B,)`` for ``(B, T)`` frames on
    ``device``; None where there is nothing to mask (no ``lengths``, or
    every row full). Reads ``lengths`` back: one sync where it lives on
    the card."""
    if lengths is None:
        return None
    host = [min(max(n, 1), T) for n in torch.as_tensor(lengths).reshape(B).tolist()]
    frames = sum(host)
    if frames == B * T:
        return None
    ln = torch.as_tensor(lengths).to(device, non_blocking=True).reshape(B).clamp(1, T)
    valid = torch.arange(T, device=device)[None] < ln[:, None]
    return RaggedRows((B, T), frames, max(host), B * T * T - sum(n * n for n in host), valid,
                      valid.reshape(-1).nonzero_static(size=frames).squeeze(1),
                      torch.nn.functional.pad(ln.cumsum(0, dtype=torch.int32), (1, 0)))


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``(B, T, H, d)`` out of ``q, k, v (B, T, H, d)``, the
    query already scaled; ``keys (B, T)`` bool the valid frames, whose keys
    are read and whose queries are kept (the others hold 0), or None for
    all (the JAX package's unmasked einsums, bit for bit)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if keys is not None:
        logits = logits.masked_fill(~keys[:, None, None, :], float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return out if keys is None else out.masked_fill(~keys[:, :, None, None], 0.0)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths=None) -> torch.Tensor:
    """``softmax(q·kᵀ + mask)·v`` per head: ``q, k, v (B, T, H, d)``, the
    query already scaled by ``1/√d``, out ``(B, T, H, d)``. With
    ``lengths`` (``(B,)``, or the :func:`ragged_rows` of it) row ``b``
    reads its first ``lengths[b]`` keys only and its queries past them hold
    0. Differentiable on every route. CUDA tensors (one device, one
    floating dtype, the feature axis contiguous) run the memory-efficient
    kernels or raise; CPU tensors run :func:`masked_attention_reference`."""
    global attention_calls, attention_masked_keys, attention_varlen_calls
    global attention_pairs_skipped
    with span("ops.attention"):
        B, T, H, d = q.shape
        rows = lengths
        if not isinstance(rows, RaggedRows):
            rows = ragged_rows(lengths, B, T, q.device)
        elif rows.shape != (B, T):
            raise ValueError(f"masked_attention: rows of {rows.shape}, q {tuple(q.shape)}")
        attention_calls += 1
        if rows is not None:
            attention_masked_keys += B * T - rows.frames
        if q.device.type == "cpu":
            return masked_attention_reference(q, k, v, None if rows is None else rows.valid)
        with span("kernels.attention"):
            _check(q, k, v)
            if rows is not None:
                attention_varlen_calls += 1
                attention_pairs_skipped += rows.pairs_skipped
                return _RaggedAttention.apply(q, k, v, rows)
            from torch.nn.attention import SDPBackend, sdpa_kernel
            from torch.nn.functional import scaled_dot_product_attention

            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2), scale=1.0)
            return out.transpose(1, 2)


class _RaggedAttention(torch.autograd.Function):
    """The ragged route: gather each row's valid frames into ``(1, N, H,
    d)``, run the memory-efficient kernels over ``cu_seqlens``, scatter the
    output into zeros. The backward gathers the output's gradient, runs
    the backward kernel and scatters each gradient into zeros, so padded
    frames get none; one packed gradient at a time is let go, which keeps
    the backward's peak near the dense route's."""

    @staticmethod
    def forward(ctx, q, k, v, rows):
        B, T, H, d = q.shape
        qp, kp, vp = (t.reshape(B * T, H, d).index_select(0, rows.index)[None] for t in (q, k, v))
        out, lse, seed, offset, _, _ = torch.ops.aten._efficient_attention_forward(
            qp, kp, vp, None, rows.cu_seqlens, rows.cu_seqlens, rows.max_seqlen,
            rows.max_seqlen, 0.0, 0, any(ctx.needs_input_grad[:3]), scale=1.0)
        ctx.rows = rows
        ctx.save_for_backward(qp, kp, vp, out, lse, seed, offset)
        return _scatter(out, rows)

    @staticmethod
    def backward(ctx, grad):
        qp, kp, vp, out, lse, seed, offset = ctx.saved_tensors
        rows = ctx.rows
        B, T, H, d = grad.shape
        g = grad.reshape(B * T, H, d).index_select(0, rows.index)[None]
        grads = list(torch.ops.aten._efficient_attention_backward(
            g, qp, kp, vp, None, out, rows.cu_seqlens, rows.cu_seqlens, rows.max_seqlen,
            rows.max_seqlen, lse, 0.0, seed, offset, 0, False, scale=1.0)[:3])
        del g
        for i, packed in enumerate(grads):
            grads[i] = _scatter(packed, rows)
        return (*grads, None)


def _scatter(packed, rows):
    """``(1, N, H, d)`` packed frames back into ``(B, T, H, d)``, zero at
    the padded ones."""
    B, T = rows.shape
    full = packed.new_zeros((B * T, *packed.shape[2:]))
    return full.index_copy_(0, rows.index, packed[0]).view(B, T, *packed.shape[2:])


def _check(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"masked_attention: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q {tuple(q.shape)} {q.dtype} on {q.device}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"masked_attention: {q.dtype} is not a floating dtype")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"masked_attention: {name}'s feature axis is not contiguous")
