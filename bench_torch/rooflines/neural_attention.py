"""The transition encoder's attention in a training step
(``ops/attention.py`` ``masked_attention`` on the card: the
memory-efficient kernels of ``scaled_dot_product_attention``, forward
and backward), over the valid queries and keys only.

A row of L valid frames does L² query-key pairs a head and layer:
forward ``q·kᵀ`` and ``w·v``, 2 operations a multiply-add, 4·L²·d; the
backward the gradients of ``w``, ``v``, ``q`` and ``k``, 8·L²·d (the
logits the kernel recomputes are not counted). Bytes: each layer's q, k,
v and output and their gradients, L·H floats each, read or written once.

The pattern matches the forward and backward kernels as the trace names
them (``fmha_cutlassF_f32_aligned_...``, ``fmha_cutlassB_f32_...``). The
harness counts one launch's work times the launches it finds, so
:func:`work` gives a step's attention over ``LAUNCHES``, the launches of
one step that the pattern matches (three layers, one forward and one
backward launch each, on an H100 under torch 2.11 with CUDA 12.8)."""

PATTERN = r"fmha_cutlass[FB]"
LAUNCHES = 6


def work(s):
    layers, heads, H = s["layers"], s["heads"], s["H"]
    d = H // heads
    flops = layers * heads * 12 * d * s["sum_sq"]
    nbytes = layers * 8 * 4 * H * s["frames"]
    return nbytes / LAUNCHES, flops / LAUNCHES
