"""Self-attention over each row's valid keys, fused on the card.

The transition encoder of ``models/neural.py`` (``NeuralTransitionModel``
with ``model_type="transformer"``) runs ``softmax(q·kᵀ + mask)·v`` once a
block. The JAX package runs it as plain XLA, two einsums around a
softmax; at a training batch (B=512, T=1000, 8 heads) each of those
``(B, H, T, T)`` tensors holds 16.4 GB in float32, and autograd keeps them
for every block.

:func:`masked_attention` is the one call site:

* CUDA tensors run ``torch.nn.functional.scaled_dot_product_attention``
  pinned to its memory-efficient backend (``sdpa_kernel``): the logits
  never leave the kernel, forward or backward, and its float32 kernels
  hold float32 accuracy, well inside TF32's
  (``tests/test_torch_neural_transformer_card.py``). Where that backend
  refuses the problem (float64, say), the call raises; it never falls
  back to a path that builds ``B·H·T·T`` elements.
* CPU tensors run :func:`masked_attention_reference`, the two einsums,
  with the padded keys set to ``-inf`` before the softmax.

A key mask from ``lengths``: row ``b`` attends to its keys ``0 ..
lengths[b] - 1`` alone, so what a valid query gives does not depend on
the row's padding. Padded queries attend to the same valid keys and hold
finite values that nobody reads. A row keeps its first key whatever its
length, so no softmax is empty and nothing turns into NaN.

Counters (module globals, read by tests and ``chip_smoke.py``):
``attention_calls``, the calls; ``attention_masked_keys``, the padded
keys masked, summed over rows and calls (its count reads the mask back:
one sync a call with ``lengths``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..trace import span

__all__ = ["masked_attention", "masked_attention_reference"]

attention_calls = 0
attention_masked_keys = 0


def _key_mask(lengths, B: int, T: int, device) -> torch.Tensor:
    """``(B, T)`` bool: key ``t`` of row ``b`` is read (``t < lengths[b]``,
    and always ``t = 0``)."""
    ln = torch.as_tensor(lengths, device=device).reshape(B, 1)
    return torch.arange(T, device=device)[None] < ln.clamp(min=1)


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``(B, T, H, d)`` out of ``q, k, v (B, T, H, d)``, the
    query already scaled; ``keys (B, T)`` bool the keys read, or None for
    all (the JAX package's unmasked einsums, bit for bit)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if keys is not None:
        logits = logits.masked_fill(~keys[:, None, None, :], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(q·kᵀ + mask)·v`` per head: ``q, k, v (B, T, H, d)``, the
    query already scaled by ``1/√d``, out ``(B, T, H, d)``. With
    ``lengths (B,)`` row ``b`` reads its first ``lengths[b]`` keys only.
    Differentiable on both routes. CUDA tensors (one device, one floating
    dtype, the feature axis contiguous) run the memory-efficient kernel or
    raise; CPU tensors run :func:`masked_attention_reference`."""
    global attention_calls, attention_masked_keys
    with span("ops.attention"):
        B, T, H, d = q.shape
        keys = None
        if lengths is not None:
            keys = _key_mask(lengths, B, T, q.device)
            attention_masked_keys += B * T - int(keys.sum())
        attention_calls += 1
        if q.device.type == "cpu":
            return masked_attention_reference(q, k, v, keys)
        with span("kernels.attention"):
            _check(q, k, v)
            from torch.nn.attention import SDPBackend, sdpa_kernel
            from torch.nn.functional import scaled_dot_product_attention

            mask = None if keys is None else keys[:, None, None, :]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2), attn_mask=mask, scale=1.0)
            return out.transpose(1, 2)


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
