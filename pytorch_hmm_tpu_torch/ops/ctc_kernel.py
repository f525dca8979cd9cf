"""The banded CTC lattice chains: forward, backward and Viterbi.

Port of the kernels of ``pytorch_hmm_tpu/ops/ctc_kernel.py``. Each
wrapper takes the reference's inputs: the gathered emissions ``lp[b, t,
s] = log_probs[t, b, label[s]]`` ``(B, T, S)``, additive 0 / ``-1e30``
masks ``(B, S)``, the boundary row (``a0`` or ``bT``) and ``input_lengths
(B,)``, all prepared by ``alignment/ctc.py``; the kernels are
label-agnostic. On CUDA tensors inside the envelope (S ≤ 2048, B ≤ 256,
any T: :func:`ctc_lattice_supported`) each launches its kernel in
``csrc/ctc_lattice.cu`` and counts it in ``.launches``; a CUDA tensor
outside it raises (the dispatch in ``alignment/ctc.py`` sends such shapes
to the plain scans on the card). CPU tensors run the plain versions here,
which repeat the kernels' arithmetic: ``lse3(stay, advance, skip)`` with
the skip as ``shifted + skip_add``, ``+ vmask``, rows frozen past each
length.

Viterbi takes :func:`ctc_lattice_viterbi` (row 22) while one sequence's
byte choice table fits the block's shared memory
(:func:`ctc_viterbi_kernel_supported`), else
:func:`ctc_lattice_viterbi_wide` (row 23, choices in device memory, any
T). Both compute one function; :func:`ctc_lattice_viterbi_reference`
serves both.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = [
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
]

_NEG = -1e30
# The reference's caps (``ops/ctc_kernel.py:51-53``): lattice positions
# and batch rows. The CUDA kernels hold two positions a thread, at most
# 1024 threads a block.
MAX_S = 2048
MAX_B = 256
# Row 22's choice table (T·S bytes a sequence) in dynamic shared memory:
# 200 KiB of the H100's 227 KB a block, the rest for the kernel's static
# arrays.
RESIDENT_CHOICE_BYTES = 200 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("ctc_lattice", {
    "ctc_lattice_forward_f32": [_P] * 6 + [_I] * 4 + [_P],
    "ctc_lattice_backward_f32": [_P] * 6 + [_I] * 4 + [_P],
    "ctc_lattice_viterbi_f32": [_P] * 9 + [_I] * 4 + [_P],
    "ctc_lattice_viterbi_wide_f32": [_P] * 10 + [_I] * 4 + [_P],
})


def ctc_lattice_supported(lattice_size: int, batch: int) -> bool:
    """True when the kernels take a lattice of ``lattice_size`` positions
    over ``batch`` rows, at any T."""
    return 1 <= lattice_size <= MAX_S and 1 <= batch <= MAX_B


def ctc_viterbi_kernel_supported(T: int, batch: int, lattice: int) -> bool:
    """Row 22: one sequence's choice table, ``T · S`` bytes, fits the
    block's shared memory."""
    return ctc_lattice_supported(lattice, batch) and T * lattice <= RESIDENT_CHOICE_BYTES


def ctc_viterbi_wide_supported(T: int, batch: int, lattice: int) -> bool:
    """Row 23: any T that fits device memory (the reference's VMEM bound
    on T is not the card's)."""
    return ctc_lattice_supported(lattice, batch)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log((torch.exp(a - m) + torch.exp(b - m)) + torch.exp(c - m))


def _down(x, k):
    """``x[:, s - k]``, ``-1e30`` below position ``k``."""
    return torch.cat([torch.full_like(x[:, :k], _NEG), x[:, :-k]], dim=1)[:, : x.shape[1]]


def _up(x, k):
    """``x[:, s + k]``, ``-1e30`` past the end."""
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], _NEG)], dim=1)[:, : x.shape[1]]


def _active(input_lengths, t):
    return (t < input_lengths)[:, None]


def ctc_lattice_forward_reference(lp, skip_add, vmask, a0, input_lengths):
    """Plain version: the kernel's recursion as a T-step loop."""
    a = torch.where((input_lengths > 0)[:, None], a0, torch.full_like(a0, _NEG))
    rows = [a]
    for t in range(1, lp.shape[1]):
        nxt = (lp[:, t] + _lse3(a, _down(a, 1), _down(a, 2) + skip_add)) + vmask
        a = torch.where(_active(input_lengths, t), nxt, a)
        rows.append(a)
    return torch.stack(rows, 1)


def ctc_lattice_backward_reference(lp, skip_fwd, vmask, bT, input_lengths):
    """Plain version: the kernel's recursion as a T-step loop."""
    T = lp.shape[1]
    b = bT
    rows = [bT] * T
    for t in range(T - 2, -1, -1):
        msg = b + lp[:, t + 1]
        nxt = _lse3(msg, _up(msg, 1), _up(msg, 2) + skip_fwd) + vmask
        b = torch.where(_active(input_lengths, t + 1), nxt, bT)
        rows[t] = b
    return torch.stack(rows, 1)


def ctc_lattice_viterbi_reference(lp, skip_add, vmask, a0, input_lengths, end1, end2):
    """Plain version of rows 22 and 23: the max trellis, its choices
    (stay > advance > skip on exact ties) and the walk back."""
    B, T, S = lp.shape
    d = a0
    choices = []
    for t in range(1, T):
        adv, skip = _down(d, 1), _down(d, 2) + skip_add
        best = torch.maximum(torch.maximum(d, adv), skip)
        choice = torch.where(best == d, 0, torch.where(best == adv, 1, 2))
        nxt = (lp[:, t] + best) + vmask
        active = _active(input_lengths, t)
        d = torch.where(active, nxt, d)
        choices.append(torch.where(active, choice, 0))
    e1, e2 = end1.long()[:, None], end2.long()[:, None]
    v1, v2 = d.gather(1, e1)[:, 0], d.gather(1, e2)[:, 0]
    pos = torch.where(v1 >= v2, e1[:, 0], e2[:, 0])
    out = [pos]
    for t in range(T - 1, 0, -1):
        # A step below 0 (paths of -1e30 scores only) stops at 0, as the
        # kernels' does.
        pos = (pos - choices[t - 1].gather(1, pos[:, None])[:, 0]).clamp_min(0)
        out.append(pos)
    return torch.stack(out[::-1], 1).int(), torch.maximum(v1, v2)


def _launch(what, entry, lp, rows, input_lengths, extra_ints, outs, scratch=()):
    """Check the problem and launch ``entry``: ``lp`` and the ``(B, S)``
    ``rows`` as float32, ``input_lengths`` and ``extra_ints`` as int32,
    then ``scratch`` and ``outs``."""
    B, T, S = lp.shape
    if not ctc_lattice_supported(S, B) or T < 1:
        raise ValueError(f"{what}: the kernel takes 1 <= S <= {MAX_S}, B <= {MAX_B}, T >= 1; "
                         f"got B={B}, T={T}, S={S}")
    dev = lp.device
    _build.check_tensors(what, dev, lp=lp, **{f"row{i}": r for i, r in enumerate(rows)})
    for i, r in enumerate(rows):
        if r.shape != (B, S):
            raise ValueError(f"{what}: row input {i} has shape {tuple(r.shape)}, expected {(B, S)}")
    ints = [x.to(device=dev, dtype=torch.int32).contiguous() for x in (input_lengths, *extra_ints)]
    if any(x.shape != (B,) for x in ints):
        raise ValueError(f"{what}: lengths and end positions must have shape {(B,)}")
    _LIB.launch(entry, what, lp, *rows, *ints, *scratch, *outs, B, T, S)


def ctc_lattice_forward(lp: torch.Tensor, skip_add: torch.Tensor, vmask: torch.Tensor,
                        a0: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """Alpha table ``(B, T, S)`` of the banded lattice, each row frozen
    from its length on; a zero-length row keeps ``-1e30``.

    CUDA tensors run the kernel (counted in ``ctc_lattice_forward.launches``):
    float32 and contiguous, 1 ≤ S ≤ 2048, B ≤ 256; anything else raises.
    CPU tensors run the plain version."""
    if lp.device.type == "cpu":
        return ctc_lattice_forward_reference(lp, skip_add, vmask, a0, input_lengths)
    alpha = torch.empty(lp.shape, dtype=torch.float32, device=lp.device)
    _launch("ctc_lattice_forward", "ctc_lattice_forward_f32", lp, (skip_add, vmask, a0),
            input_lengths, (), (alpha,))
    ctc_lattice_forward.launches += 1
    return alpha


ctc_lattice_forward.launches = 0


def ctc_lattice_backward(lp: torch.Tensor, skip_fwd: torch.Tensor, vmask: torch.Tensor,
                         bT: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """Beta table ``(B, T, S)``: frames whose successor is at or past the
    row's end hold ``bT``; the recursion at frame t consumes ``lp[t + 1]``.
    Launch rules as :func:`ctc_lattice_forward` (counted in
    ``ctc_lattice_backward.launches``)."""
    if lp.device.type == "cpu":
        return ctc_lattice_backward_reference(lp, skip_fwd, vmask, bT, input_lengths)
    beta = torch.empty(lp.shape, dtype=torch.float32, device=lp.device)
    _launch("ctc_lattice_backward", "ctc_lattice_backward_f32", lp, (skip_fwd, vmask, bT),
            input_lengths, (), (beta,))
    ctc_lattice_backward.launches += 1
    return beta


ctc_lattice_backward.launches = 0


def _viterbi_outputs(lp):
    B, T, _ = lp.shape
    return (torch.empty((B, T), dtype=torch.int32, device=lp.device),
            torch.empty((B,), dtype=torch.float32, device=lp.device))


def ctc_lattice_viterbi(lp: torch.Tensor, skip_add: torch.Tensor, vmask: torch.Tensor,
                        a0: torch.Tensor, input_lengths: torch.Tensor, end1: torch.Tensor,
                        end2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Most likely lattice positions ``(B, T) int32`` and score ``(B,)``:
    frames past each row's length repeat its final position, ties go
    stay > advance > skip, the end position is ``end1`` iff its score ≥
    ``end2``'s. CUDA tensors run the kernel with the choices resident in
    shared memory (counted in ``ctc_lattice_viterbi.launches``) and raise
    outside :func:`ctc_viterbi_kernel_supported`; CPU tensors run the
    plain version."""
    if lp.device.type == "cpu":
        return ctc_lattice_viterbi_reference(lp, skip_add, vmask, a0, input_lengths, end1, end2)
    B, T, S = lp.shape
    if not ctc_viterbi_kernel_supported(T, B, S):
        raise ValueError(f"ctc_lattice_viterbi: a (T={T}, S={S}) choice table exceeds "
                         f"{RESIDENT_CHOICE_BYTES} bytes of shared memory; use ctc_lattice_viterbi_wide")
    positions, score = _viterbi_outputs(lp)
    _launch("ctc_lattice_viterbi", "ctc_lattice_viterbi_f32", lp, (skip_add, vmask, a0),
            input_lengths, (end1, end2), (positions, score))
    ctc_lattice_viterbi.launches += 1
    return positions, score


ctc_lattice_viterbi.launches = 0


def ctc_lattice_viterbi_wide(lp: torch.Tensor, skip_add: torch.Tensor, vmask: torch.Tensor,
                             a0: torch.Tensor, input_lengths: torch.Tensor, end1: torch.Tensor,
                             end2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ctc_lattice_viterbi` at any T: the kernel writes its choices
    to a ``(B, T, S)`` byte buffer in device memory and walks them back in
    the same launch (counted in ``ctc_lattice_viterbi_wide.launches``)."""
    if lp.device.type == "cpu":
        return ctc_lattice_viterbi_reference(lp, skip_add, vmask, a0, input_lengths, end1, end2)
    positions, score = _viterbi_outputs(lp)
    choices = torch.empty(lp.shape, dtype=torch.uint8, device=lp.device)
    _launch("ctc_lattice_viterbi_wide", "ctc_lattice_viterbi_wide_f32", lp, (skip_add, vmask, a0),
            input_lengths, (end1, end2), (positions, score), scratch=(choices,))
    ctc_lattice_viterbi_wide.launches += 1
    return positions, score


ctc_lattice_viterbi_wide.launches = 0
