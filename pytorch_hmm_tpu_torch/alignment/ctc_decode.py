"""Batched CTC decoding on the device: greedy and prefix beam search.

Port of ``pytorch_hmm_tpu/alignment/ctc_decode.py``, plain torch (the JAX
package has no kernel here):

* :func:`greedy_decode_batch`: argmax, collapse repeats, drop blanks as
  one masked cumsum and scatter. No host loop, no host sync.
* :func:`beam_search_decode_batch`: an exact fixed-width prefix beam
  search over the whole batch at once. Beams live in fixed-shape
  buffers ``(B, W, L)``; each frame every beam expands into blank /
  repeat / new-token candidates, candidates that reach the same prefix
  (equal rolling hashes) are merged by a logsumexp over each hash group,
  and the best W first occurrences survive.

Both return padded ``(tokens (B, L), lengths (B,))`` int32 tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["greedy_decode_batch", "beam_search_decode_batch"]

_NEG = -1e30
# The rolling prefix hash is uint32 arithmetic that wraps: emulated in
# int64 and masked to 32 bits after every product.
_HASH_MULT = 1000003
_U32 = 0xFFFFFFFF
_DEAD = 0x80000000


def greedy_decode_batch(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                        blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy CTC decode on ``log_probs``' device.

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities.
        input_lengths: ``(B,)`` valid frame counts.
        blank_id: blank token id.

    Returns:
        ``(tokens (B, T), out_lengths (B,))``: row ``b`` holds its decoded
        tokens in ``tokens[b, :out_lengths[b]]``, padded with ``blank_id``.
    """
    T, B, _ = log_probs.shape
    dev = log_probs.device
    lengths = torch.as_tensor(input_lengths, device=dev)
    best = torch.argmax(log_probs, dim=-1).T.to(torch.int32)  # (B, T), first of ties
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev), best[:, :-1]], dim=1)
    in_range = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    # Collapse repeats first, then drop blanks (the standard CTC rule).
    keep = (best != prev) & (best != blank_id) & in_range
    # Each kept frame's output slot; dropped frames go to a spare column.
    idx = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    tokens = torch.full((B, T + 1), blank_id, dtype=torch.int32, device=dev)
    tokens.scatter_(1, idx, best)
    return tokens[:, :T].contiguous(), keep.sum(dim=1).to(torch.int32)


def _group_logsumexp(v, group):
    """Per candidate, the logsumexp of ``v (..., N)`` over its hash group
    (``group (B, N)``, ids below N): the group's max plus the log of its
    shifted sum (a group of all ``-inf`` gives ``-inf``)."""
    idx = group.expand_as(v)
    m = torch.full_like(v, float("-inf")).scatter_reduce(-1, idx, v, reduce="amax")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.zeros_like(v).scatter_add_(-1, idx, torch.exp(v - m.gather(-1, idx)))
    return (m + torch.log(s)).gather(-1, idx)


def beam_search_decode_batch(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                             beam_width: int = 4, blank_id: int = 0,
                             max_tokens: Optional[int] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exact prefix beam search on ``log_probs``' device.

    Args:
        log_probs: ``(T, B, C)`` frame log-probabilities.
        input_lengths: ``(B,)`` valid frame counts.
        beam_width: number of live prefixes per sequence.
        blank_id: blank token id.
        max_tokens: output-length cap (default ``T``).

    Returns:
        ``(tokens (B, L), out_lengths (B,))`` for the best prefix of each
        sequence, padded with ``blank_id``.

    Ranks ties by lower candidate index, as ``jax.lax.top_k`` does (a
    stable descending sort); the candidates are each beam's kept prefix,
    then each beam's extensions in token order.
    """
    T, B, C = log_probs.shape
    W = beam_width
    L = max_tokens if max_tokens is not None else T
    dev, dtype = log_probs.device, log_probs.dtype
    lengths = torch.as_tensor(input_lengths, device=dev)
    N = W + W * C
    rows = torch.arange(B, device=dev)[:, None]
    c_ids = torch.arange(C, device=dev)
    cand_parent = torch.cat([torch.arange(W, device=dev),
                             torch.arange(W, device=dev).repeat_interleave(C)])
    cand_new = torch.cat([torch.full((W,), -1, device=dev), c_ids.repeat(W)]).to(torch.int32)
    dead_h = _DEAD + torch.arange(N, device=dev)
    slots = torch.arange(L, device=dev)
    neg = torch.tensor(_NEG, dtype=dtype, device=dev)

    tokens = torch.zeros((B, W, L), dtype=torch.int32, device=dev)
    lens = torch.zeros((B, W), dtype=torch.int64, device=dev)
    h = torch.zeros((B, W), dtype=torch.int64, device=dev)
    pb = torch.full((B, W), _NEG, dtype=dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, W), _NEG, dtype=dtype, device=dev)
    for t in range(T):
        lp_t = log_probs[t]  # (B, C)
        p_tot = torch.logaddexp(pb, pnb)
        last = tokens.gather(2, (lens - 1).clamp_min(0)[..., None])[..., 0].long()
        has_last = lens > 0
        # Candidates that keep each beam's prefix: any path + blank, and
        # the non-blank-ending mass + the last token again.
        keep_pb = p_tot + lp_t[:, blank_id, None]
        keep_pnb = pnb + torch.where(has_last, lp_t.gather(1, torch.where(has_last, last, 0)), neg)
        # Candidates that extend each beam by a non-blank token c: a repeat
        # of the last token needs an intervening blank.
        is_rep = has_last[..., None] & (c_ids == last[..., None])
        ext_pnb = torch.where(is_rep, pb[..., None], p_tot[..., None]) + lp_t[:, None, :]
        ext_pnb = torch.where(c_ids == blank_id, neg, ext_pnb)
        ext_pnb = torch.where(lens[..., None] >= L, neg, ext_pnb)  # buffer full
        cand_h = torch.cat([h, ((h[..., None] * _HASH_MULT + c_ids + 1) & _U32).reshape(B, -1)], 1)
        cand_pb = torch.cat([keep_pb, neg.expand(B, W * C)], dim=1)
        cand_pnb = torch.cat([keep_pnb, ext_pnb.reshape(B, -1)], dim=1)
        # Dead candidates get unique sentinel hashes, so they never merge.
        dead = torch.maximum(cand_pb, cand_pnb) <= _NEG / 2
        cand_h = torch.where(dead, dead_h, cand_h)
        # Hash groups: sorted hashes, a new group at each change; the
        # stable sort puts each group's lowest index at its start.
        sorted_h, order = torch.sort(cand_h, dim=1, stable=True)
        starts = torch.cat([torch.ones_like(sorted_h[:, :1], dtype=torch.bool),
                            sorted_h[:, 1:] != sorted_h[:, :-1]], dim=1)
        group = torch.empty_like(order).scatter_(1, order, torch.cumsum(starts, dim=1) - 1)
        first = torch.empty_like(starts).scatter_(1, order, starts)
        pb_m, pnb_m = _group_logsumexp(torch.stack([cand_pb, cand_pnb]), group)
        total = torch.where(first, torch.logaddexp(pb_m, pnb_m), float("-inf"))
        top = torch.sort(total, dim=1, descending=True, stable=True)[1][:, :W]
        parent = cand_parent[top]
        new_tok = cand_new[top]
        new_tokens = tokens[rows, parent]
        new_lens = lens[rows, parent]
        appended = new_tok >= 0
        at_slot = appended[..., None] & (slots == new_lens.clamp_max(L - 1)[..., None])
        new_tokens = torch.where(at_slot, new_tok[..., None], new_tokens)
        new_lens = new_lens + appended
        # Frames past a row's length leave its beams untouched.
        active = (t < lengths)[:, None]
        tokens = torch.where(active[..., None], new_tokens, tokens)
        lens = torch.where(active, new_lens, lens)
        h = torch.where(active, cand_h.gather(1, top), h)
        pb = torch.where(active, torch.maximum(pb_m.gather(1, top), neg), pb)
        pnb = torch.where(active, torch.maximum(pnb_m.gather(1, top), neg), pnb)
    best = torch.argmax(torch.logaddexp(pb, pnb), dim=1)
    out_len = lens[rows[:, 0], best]
    out = torch.where(slots[None, :] < out_len[:, None], tokens[rows[:, 0], best], blank_id)
    return out.to(torch.int32), out_len.to(torch.int32)
