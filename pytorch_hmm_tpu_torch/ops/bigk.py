"""Large-state sequence log-likelihood: the prob-space chain with bf16
products on the tensor cores.

Port of ``pytorch_hmm_tpu/ops/bigk.py`` (``bigk_log_likelihood``). For
each sequence, with ``P = bf16(exp(log_a))``::

    m_t = max_k lo_t,  e_t = exp(lo_t - m_t)
    q_0 = exp(log_pi + (lo_0 - m_0)),  rescaled by its max
    q_t = (bf16(q_{t-1}) @ P) * e_t,    C += m_t

the products taking bf16 operands and float32 sums (the TPU kernel's
DEFAULT-precision dot). ``q`` is rescaled by its row max (floored at
1e-37, ``C += log r``) after every 16 frames of each ``t_chunk``-frame
chunk and at each chunk's end, on the reference's schedule (its first
chunk starts at frame 1). The likelihood is ``logsumexp_k(log(max(q,
1e-37)) + C)``. Scoring grade, no gradient: the bf16 rounding of ``q``
each frame leaves ~1e-2 nats at T=2048.

Inside :func:`bigk_supported` (K ≤ 1024, B ≤ 4096) a CUDA tensor with
``T % t_chunk == 0`` launches the kernel of ``csrc/bigk_scoring.cu``,
counted in ``bigk_log_likelihood.launches``: one thread-block cluster of
CS CTAs per 16 rows, each holding a ``Kp / CS``-column slice of P
(:func:`cluster_plan`, :func:`cluster_fragments`; CS from the shape by
:func:`cluster_size`, 16, a non-portable cluster size, at K > 960). Where the card cannot hold such a
cluster the launch raises. A CPU tensor runs the plain version. ``T %
t_chunk != 0`` takes ``pallas_forward``'s log Z on any device, as the
reference does (a padded frame would be a real transition step). A shape
outside the envelope raises on every device.
Log-obs are read as float32 always: the reference's bf16 stream is a
VMEM budget, not part of the function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .scan import pallas_forward

__all__ = [
    "ClusterPlan",
    "MAX_BIGK_BATCH",
    "MAX_BIGK_STATES",
    "bigk_log_likelihood",
    "bigk_log_likelihood_reference",
    "bigk_supported",
    "cluster_fragments",
    "cluster_plan",
    "cluster_size",
    "slice_smem",
]

# The reference's state cap (``_MAX_K``); the batch bound is the port's
# (256 clusters of 16 rows, run in waves of what the card holds). The
# reference's VMEM gate takes at most ~216 rows at K ≤ 128 and 48 at
# K=512.
MAX_BIGK_STATES = 1024
MAX_BIGK_BATCH = 4096
T_CHUNK = 128
RESCALE = 16
_FLOOR = 1e-37
# The cluster kernel's tiling (csrc/bigk_scoring.cu): 16 rows a cluster,
# a slice of NC columns a CTA (NC one of SLICE_WIDTHS), k split over 4
# warps, row maxima exchanged per 64-column group.
CLUSTER_ROWS, KSPLIT, GROUP_COLS = 16, 4, 64
SLICE_WIDTHS = (64, 128, 192, 256)
SMEM_LIMIT = 232448
CARD_SMS = 132   # the H100 SXM's
# cudaErrorInvalidClusterSize: the card cannot hold one cluster.
_CLUSTER_REFUSED = 912

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("bigk_scoring", {
    "bigk_scoring_f32": [_P] * 4 + [_I] * 6 + [_I, _P],
    "bigk_active_clusters": [_I] * 4 + [_P],
})


def bigk_supported(num_states: int, batch: int) -> bool:
    """True when the scoring op takes ``num_states`` states over
    ``batch`` rows."""
    return 1 <= num_states <= MAX_BIGK_STATES and 1 <= batch <= MAX_BIGK_BATCH


def padded_states(num_states: int) -> int:
    """The kernel's state padding: a multiple of 64 (eight mma n-tiles)."""
    return -(-num_states // 64) * 64


class ClusterPlan(NamedTuple):
    kp: int        # K padded to a multiple of 64
    cs: int        # CTAs a cluster, each holding kp / cs columns of P
    rows: int      # batch rows a cluster
    clusters: int  # clusters the launch runs (in waves if the card holds fewer)
    smem: int      # dynamic shared memory bytes a CTA takes


def slice_smem(kp: int, nc: int) -> int:
    """Shared memory bytes of a CTA owning ``nc`` of ``kp`` columns: its
    slice of P (bf16), both bf16 q buffers (rows padded by 8), the four k
    partials (float32, rows padded by 8) and three sets of ``kp / 64`` row
    maxima."""
    rows = CLUSTER_ROWS
    return (kp * nc * 2 + 2 * rows * (kp + 8) * 2 + KSPLIT * rows * (nc + 8) * 4
            + 3 * (kp // GROUP_COLS) * rows * 4)


def cluster_size(kp: int, batch: int) -> int:
    """CTAs a cluster at ``kp`` padded states over ``batch`` rows: one per
    64 columns while all ``ceil(batch / 16)`` clusters fit on the card at
    once (one CTA an SM), so each frame's product spreads over the most
    SMs; past that, the fewest CTAs whose slice fits in shared memory, so
    the most row tiles run at once (on the H100, K=256 at B=4096: one CTA
    a cluster, 1.90 ms against 3.63 with four; K=512: four, 7.19 ms
    against 12.93 with eight; kernel_ab.py)."""
    wide = kp // GROUP_COLS
    if -(-batch // CLUSTER_ROWS) * wide <= CARD_SMS:
        return wide
    return next(cs for cs in range(1, wide + 1)
                if kp % cs == 0 and kp // cs in SLICE_WIDTHS and slice_smem(kp, kp // cs) <= SMEM_LIMIT)


def cluster_plan(num_states: int, batch: int, cs: int | None = None) -> ClusterPlan:
    """The kernel's launch at ``num_states`` states over ``batch`` rows
    (``cs`` CTAs a cluster, :func:`cluster_size` unless given): the one
    plan the wrapper passes to the kernel, which checks its bytes against
    its own shared-memory layout."""
    kp = padded_states(num_states)
    cs = cluster_size(kp, batch) if cs is None else cs
    if cs < 1 or kp % cs or kp // cs not in SLICE_WIDTHS:
        raise ValueError(f"bigk_log_likelihood: no slice of {kp} states over {cs} CTAs")
    smem = slice_smem(kp, kp // cs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bigk_log_likelihood: a slice of {kp} states over {cs} CTAs takes "
                         f"{smem} bytes of shared memory, over {SMEM_LIMIT}")
    return ClusterPlan(kp, cs, CLUSTER_ROWS, -(-batch // CLUSTER_ROWS), smem)


def rescales_after(t: int, t_chunk: int) -> bool:
    """True when ``q`` is rescaled after frame ``t >= 1``: the last frame
    of each block of 16 within its chunk, and each chunk's last frame.
    Chunk 0 holds frames 1..t_chunk-1 (frame 0 is the prior)."""
    c, f = divmod(t, t_chunk)
    pos, n = (f - 1, t_chunk - 1) if c == 0 else (f, t_chunk)
    return (pos + 1) % RESCALE == 0 or pos == n - 1


def _rescaled(q: torch.Tensor, c: torch.Tensor):
    r = q.amax(dim=-1, keepdim=True).clamp_min(_FLOOR)
    return q * (1.0 / r), c + torch.log(r)


def bigk_log_likelihood_reference(log_obs: torch.Tensor, log_a: torch.Tensor,
                                  log_pi: torch.Tensor, t_chunk: int = T_CHUNK) -> torch.Tensor:
    """Plain version of the chain (``T % t_chunk == 0``): float32 math on
    bf16-rounded operands, ``q.to(bf16).float() @ P.float()``, a T-step
    loop on the tensors' device."""
    lo = log_obs.float()
    pa = torch.exp(log_a.float()).to(torch.bfloat16).float()
    m = lo[:, 0].amax(dim=-1, keepdim=True)
    q = torch.exp(log_pi.float() + (lo[:, 0] - m))
    q, c = _rescaled(q, m)
    for t in range(1, lo.shape[1]):
        lo_t = lo[:, t]
        m = lo_t.amax(dim=-1, keepdim=True)
        q = (q.to(torch.bfloat16).float() @ pa) * torch.exp(lo_t - m)
        c = c + m
        if rescales_after(t, t_chunk):
            q, c = _rescaled(q, c)
    return torch.logsumexp(torch.log(q.clamp_min(_FLOOR)) + c, dim=-1)


def _fragments(pa: torch.Tensor) -> torch.Tensor:
    """``(Kp, Kp)`` bf16 → ``(Kp/16, Kp/8, 32, 4)``: for each 16-row k-tile
    and 8-column n-tile the 32 lanes' ``mma.m16n8k16`` B fragments, lane
    ``l`` holding rows ``2(l%4) + {0, 1, 8, 9}`` of column ``l/4``, so a
    warp reads a tile as 256 contiguous bytes."""
    kp = pa.shape[0]
    dev = pa.device
    kt = torch.arange(kp // 16, device=dev)[:, None, None, None]
    nt = torch.arange(kp // 8, device=dev)[None, :, None, None]
    lane = torch.arange(32, device=dev)[None, None, :, None]
    e = torch.arange(4, device=dev)[None, None, None, :]
    k = kt * 16 + (lane % 4) * 2 + (e % 2) + 8 * (e // 2)
    return pa[k, nt * 8 + lane // 4].contiguous()


def cluster_fragments(pa: torch.Tensor, cs: int) -> torch.Tensor:
    """``(Kp, Kp)`` → ``(cs, Kp/16, Kp/(8 cs), 32, 4)``: CTA ``c``'s columns
    ``[c Kp/cs, (c+1) Kp/cs)`` of P, all rows, in the B-fragment order of
    :func:`_fragments`, each slice contiguous."""
    kp = pa.shape[0]
    frags = _fragments(pa)
    return frags.reshape(kp // 16, cs, kp // (8 * cs), 32, 4).transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=8)
def _slice_index(kp: int, cs: int, device: torch.device) -> torch.Tensor:
    """Flat positions in ``P.reshape(-1)`` of :func:`cluster_fragments`'
    layout, so a call lays P out with one gather."""
    flat = torch.arange(kp * kp, device=device).reshape(kp, kp)
    return cluster_fragments(flat, cs).reshape(-1)


def active_clusters(num_states: int, plan: ClusterPlan, device: torch.device) -> int:
    """Clusters of ``plan`` at ``num_states`` states that the card
    ``device`` holds at once (builds the kernel)."""
    n = ctypes.c_int(0)
    _build.check(_LIB.fn("bigk_active_clusters")(num_states, plan.cs, plan.smem, device.index or 0,
                                                 ctypes.byref(n)), "bigk_log_likelihood occupancy")
    return n.value


def bigk_log_likelihood(log_obs: torch.Tensor, log_a: torch.Tensor, log_pi: torch.Tensor,
                        t_chunk: int = T_CHUNK) -> torch.Tensor:
    """Sequence log-likelihood ``(B,)`` of ``log_obs (B, T, K)`` under
    static ``log_a (K, K)`` (finite: the prob-space envelope) and
    ``log_pi (K,)``; scoring grade (module docstring).

    CUDA tensors with ``T % t_chunk == 0`` run the kernel (counted in
    ``bigk_log_likelihood.launches``): float32 and contiguous, recording
    no gradient. CPU tensors run the plain version."""
    B, T, K = log_obs.shape
    if not bigk_supported(K, B):
        raise ValueError(f"bigk_log_likelihood: unsupported (K={K}, B={B}); the op takes "
                         f"K <= {MAX_BIGK_STATES}, B <= {MAX_BIGK_BATCH}")
    if t_chunk < 1:
        raise ValueError(f"bigk_log_likelihood: t_chunk must be positive, got {t_chunk}")
    if T % t_chunk != 0:
        return pallas_forward(log_obs.float().contiguous(), log_a.float().contiguous(),
                              log_pi.float().contiguous())[1]
    if log_obs.device.type == "cpu":
        return bigk_log_likelihood_reference(log_obs, log_a, log_pi, t_chunk)
    dev = log_obs.device
    _build.check_tensors("bigk_log_likelihood", dev, log_obs=log_obs, log_a=log_a, log_pi=log_pi)
    if log_a.shape != (K, K) or log_pi.shape != (K,):
        raise ValueError(f"bigk_log_likelihood: log_a {tuple(log_a.shape)} and log_pi "
                         f"{tuple(log_pi.shape)} do not match K={K}")
    return _launch(log_obs, log_a, log_pi, t_chunk, cluster_plan(K, B))


def _launch(log_obs, log_a, log_pi, t_chunk: int, plan: ClusterPlan) -> torch.Tensor:
    """One launch of the kernel on ``plan`` (counted in
    ``bigk_log_likelihood.launches``); the logsumexp of its output."""
    B, T, K = log_obs.shape
    dev = log_obs.device
    pa = torch.zeros((plan.kp, plan.kp), dtype=torch.bfloat16, device=dev)
    pa[:K, :K] = torch.exp(log_a)
    frags = pa.reshape(-1)[_slice_index(plan.kp, plan.cs, dev)]
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    try:
        _LIB.launch("bigk_scoring_f32", "bigk_log_likelihood", log_obs, frags, log_pi, out,
                    B, T, K, plan.cs, plan.smem, t_chunk)
    except _build.LaunchError as e:
        if e.rc != _CLUSTER_REFUSED:
            raise
        raise RuntimeError(f"bigk_log_likelihood: the card cannot hold a cluster of {plan.cs} CTAs "
                           f"with {plan.smem} bytes of shared memory each (K={K})") from None
    bigk_log_likelihood.launches += 1
    return torch.logsumexp(out, dim=-1)


bigk_log_likelihood.launches = 0
