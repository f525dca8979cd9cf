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
counted in ``bigk_log_likelihood.launches``; a CPU tensor runs the plain
version. ``T % t_chunk != 0`` takes ``pallas_forward``'s log Z on any
device, as the reference does (a padded frame would be a real
transition step). A shape outside the envelope raises on every device.
Log-obs are read as float32 always: the reference's bf16 stream is a
VMEM budget, not part of the function.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scan import pallas_forward

__all__ = [
    "MAX_BIGK_BATCH",
    "MAX_BIGK_STATES",
    "bigk_log_likelihood",
    "bigk_log_likelihood_reference",
    "bigk_supported",
]

# The reference's state cap (``_MAX_K``); the batch bound is the port's
# (256 blocks of 16 rows, two waves of the H100's 132 SMs). The
# reference's VMEM gate takes at most ~216 rows at K ≤ 128 and 48 at
# K=512.
MAX_BIGK_STATES = 1024
MAX_BIGK_BATCH = 4096
T_CHUNK = 128
RESCALE = 16
_FLOOR = 1e-37

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"bigk_scoring_f32": [_P] * 4 + [_I] * 4 + [_I, _P]}


def bigk_supported(num_states: int, batch: int) -> bool:
    """True when the scoring op takes ``num_states`` states over
    ``batch`` rows."""
    return 1 <= num_states <= MAX_BIGK_STATES and 1 <= batch <= MAX_BIGK_BATCH


def padded_states(num_states: int) -> int:
    """The kernel's state padding: a multiple of 64 (eight mma n-tiles)."""
    return -(-num_states // 64) * 64


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
    kp = padded_states(K)
    pa = torch.zeros((kp, kp), dtype=torch.bfloat16, device=dev)
    pa[:K, :K] = torch.exp(log_a)
    frags = _fragments(pa)
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    lib = _build.load("bigk_scoring", _SIGNATURES)
    rc = lib.bigk_scoring_f32(log_obs.data_ptr(), frags.data_ptr(), log_pi.data_ptr(),
                              out.data_ptr(), B, T, K, t_chunk, dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "bigk_log_likelihood")
    bigk_log_likelihood.launches += 1
    return torch.logsumexp(out, dim=-1)


bigk_log_likelihood.launches = 0
