"""The DTW wavefront and backtrace in one launch.

Port of ``pytorch_hmm_tpu/ops/dtw.py`` (``pallas_dtw``). The hard-DTW
recurrence over a distance matrix ``dist (N, M)``::

    D[i, j] = dist[i, j] + min(D[i-1, j-1], D[i-1, j], D[i, j-1])

(``rabiner_juang``: the diagonal candidate adds ``2 · dist[i, j]``;
``symmetric`` and ``asymmetric`` are the same recurrence), cell (0, 0)
taking ``dist[0, 0]``, then a walk back from (N-1, M-1) over the stored
choices. Every cell of anti-diagonal ``k = i + j`` needs only diagonals
``k-1`` and ``k-2``, so the recurrence runs as N+M-1 vector steps.

On CUDA tensors inside :func:`pallas_dtw_supported` (N ≤ 4096, M ≤
65536) :func:`pallas_dtw` launches the kernel of ``csrc/dtw.cu``, counted
in ``pallas_dtw.launches``; a CUDA tensor outside it raises. CPU tensors
run the plain version, :func:`pallas_dtw_reference`, which is the JAX
package's XLA scan pair (``_dtw_wavefront`` + ``_backtrace``) in torch.
The three are bit-identical: the same sums, ``min``, the tie order diag
> up > left as an explicit ``where`` chain (all three candidates
``+inf`` give choice 0), and the same path convention (N+M-1 steps,
frozen at the origin, reversed so the leading entries are (0, 0)).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = [
    "MAX_DTW_M",
    "MAX_DTW_N",
    "dtw_backtrace",
    "dtw_wavefront",
    "pallas_dtw",
    "pallas_dtw_reference",
    "pallas_dtw_supported",
]

_INF = float("inf")
# The kernel's envelope: one thread a row, at most four rows a thread over
# 1024 threads; the columns only lengthen the diagonal loop and the choice
# table. It takes every shape the reference's VMEM gate takes (N ≲ 1024,
# M ≲ 5120, e.g. 500x500) and more.
MAX_DTW_N = 4096
MAX_DTW_M = 65536
_PATTERNS = ("symmetric", "asymmetric", "rabiner_juang")

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("dtw", {"dtw_f32": [_P] * 6 + [_I] * 4 + [_P]})


def pallas_dtw_supported(n: int, m: int) -> bool:
    """True when the kernel takes an ``(n, m)`` distance matrix."""
    return 1 <= n <= MAX_DTW_N and 1 <= m <= MAX_DTW_M


def _check_pattern(step_pattern: str) -> None:
    if step_pattern not in _PATTERNS:
        raise ValueError(f"unknown step pattern {step_pattern!r}; expected one of {_PATTERNS}")


def dtw_wavefront(dist: torch.Tensor, step_pattern: str = "symmetric"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anti-diagonal scan: ``(cost (N, M), choices (N, M) int8)``,
    choice 0 = diagonal, 1 = up (i-1, j), 2 = left (i, j-1). Runs on
    ``dist``'s device, one vector step a diagonal."""
    _check_pattern(step_pattern)
    N, M = dist.shape
    dev = dist.device
    i_idx = torch.arange(N, device=dev)
    inf_row = torch.full((N,), _INF, dtype=dist.dtype, device=dev)
    inf1 = inf_row[:1]
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    one, two = zero + 1, zero + 2
    rj = step_pattern == "rabiner_juang"
    d1, d2 = inf_row, inf_row
    diags, choices = [], []
    for k in range(N + M - 1):
        j = k - i_idx
        valid = (j >= 0) & (j < M)
        dk = torch.where(valid, dist[i_idx, j.clamp(0, M - 1)], inf_row)
        diag = torch.cat([inf1, d2[:-1]])   # (i-1, j-1)
        up = torch.cat([inf1, d1[:-1]])     # (i-1, j)
        left = d1                           # (i, j-1)
        c0 = diag + 2.0 * dk if rj else diag + dk
        c1, c2 = up + dk, left + dk
        best = torch.minimum(torch.minimum(c0, c1), c2)
        choice = torch.where(best == c0, zero, torch.where(best == c1, one, two))
        if k == 0:
            best = torch.where(i_idx == 0, dk, best)
        best = torch.where(valid, best, inf_row)
        diags.append(best)
        choices.append(choice)
        d1, d2 = best, d1
    # Re-fold the diagonals into (N, M): cell (i, j) lives at diags[i + j, i].
    kk = i_idx[:, None] + torch.arange(M, device=dev)[None, :]
    ii = i_idx[:, None].expand(N, M)
    return torch.stack(diags)[kk, ii], torch.stack(choices)[kk, ii]


def dtw_backtrace(choices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk ``choices`` from (N-1, M-1) to (0, 0): ``(path_i, path_j,
    length)``, N+M-1 entries each, origin first; the entries before the
    last ``length`` are frozen at (0, 0). Runs on ``choices``' device with
    no read back to the host."""
    N, M = choices.shape
    dev = choices.device
    flat = choices.reshape(-1)
    i = torch.tensor(N - 1, device=dev)
    j = torch.tensor(M - 1, device=dev)
    pis, pjs = [], []
    for _ in range(N + M - 1):
        pis.append(i)
        pjs.append(j)
        c = flat[i * M + j]
        at_origin = (i == 0) & (j == 0)
        ni = torch.where(at_origin, 0, i - (c != 2).long())
        nj = torch.where(at_origin, 0, j - (c != 1).long())
        i, j = ni.clamp_min(0), nj.clamp_min(0)
    pi, pj = torch.stack(pis), torch.stack(pjs)
    length = ((pi + pj) > 0).sum() + 1
    return pi.flip(0).int(), pj.flip(0).int(), length.int()


def pallas_dtw_reference(dist: torch.Tensor, step_pattern: str = "symmetric"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``(path_i, path_j, length, final_cost)`` from
    :func:`dtw_wavefront` and :func:`dtw_backtrace`."""
    cost, choices = dtw_wavefront(dist, step_pattern)
    pi, pj, length = dtw_backtrace(choices)
    return pi, pj, length, cost[-1, -1]


def pallas_dtw(dist: torch.Tensor, step_pattern: str = "symmetric"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """DTW path and cost: ``(path_i (N+M-1,) int32, path_j (N+M-1,)
    int32, length () int32, final_cost () float32)``, the path in
    :func:`dtw_backtrace`'s convention.

    CUDA tensors run the kernel (counted in ``pallas_dtw.launches``):
    float32 and contiguous, inside :func:`pallas_dtw_supported`; anything
    else raises. CPU tensors run the plain version."""
    if dist.device.type == "cpu":
        return pallas_dtw_reference(dist, step_pattern)
    _check_pattern(step_pattern)
    if dist.ndim != 2 or not pallas_dtw_supported(*dist.shape):
        raise ValueError(f"pallas_dtw: the kernel takes (N, M) with 1 <= N <= {MAX_DTW_N}, "
                         f"1 <= M <= {MAX_DTW_M}; got {tuple(dist.shape)}")
    dev = dist.device
    _build.check_tensors("pallas_dtw", dev, dist=dist)
    N, M = dist.shape
    W2 = N + M - 1
    path_i = torch.empty((W2,), dtype=torch.int32, device=dev)
    path_j = torch.empty((W2,), dtype=torch.int32, device=dev)
    length = torch.empty((), dtype=torch.int32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    # The 2-bit choice table, (ceil(W2 / 16), N) words: the kernel keeps it
    # in shared memory when it fits there and uses this buffer otherwise
    # (csrc/dtw.cu).
    table = torch.empty(((W2 + 15) // 16) * N, dtype=torch.int32, device=dev)
    _LIB.launch("dtw_f32", "pallas_dtw", dist, table, path_i, path_j, length, cost, N, M,
                int(step_pattern == "rabiner_juang"))
    pallas_dtw.launches += 1
    return path_i, path_j, length, cost


pallas_dtw.launches = 0
