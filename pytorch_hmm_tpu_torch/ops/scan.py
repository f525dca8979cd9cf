"""Forward, backward and Viterbi chains for more than 32 states, and the
long-sequence prob-space chains.

Port of the kernels of ``pytorch_hmm_tpu/ops/scan.py``:

* the log-space ``pallas_forward``, ``pallas_backward`` and
  ``pallas_viterbi``: on CUDA tensors each launches its kernel in
  ``csrc/scan_bigk.cu`` (one block per sequence, any K up to 1024,
  static ``(K, K)`` transitions, optional ``lengths``). The dispatch
  (``ops.auto_*``) sends ``33 <= K <= 1024`` to them
  (:func:`scan_supported`); K ≤ 32 goes to the small-K kernels.
* the scaled prob-space ``pallas_forward_prob``, ``pallas_backward_prob``
  and ``pallas_fb_prob`` (:func:`prob_supported`: K ≤ 128, unragged):
  on CUDA tensors each launches its kernel in ``csrc/scan_prob.cu``. The
  dispatch sends long unragged sequences with finite transitions to
  them (``ops._sum_route``).

On CPU tensors each runs its plain version here.

The sum chains compute what the TPU kernels compute, in the scaling
form::

    alpha_t = lo_t + c + log(exp(alpha_{t-1} - c) @ exp(log_a)),  c = max alpha_{t-1}
    beta_t  = c + log(exp(lo_{t+1} + beta_{t+1} - c) @ exp(log_a).T),  c >= -1e30

so a state reached only through mass below ``e^-87`` of the frame's
largest gets ``-inf``, where the logsumexp ``core`` gives a finite
value; posteriors agree. The plain versions run the same prob-space
step as a T-step loop, so the card comparison is tight. The Viterbi's
plain version is ``core.viterbi``: paths and scores are bit-identical,
lowest-index ties included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import core
from . import _build
from ._build import MAX_SMALLK, check_problem

__all__ = [
    "MAX_K",
    "PROB_MAX_K",
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
]

# The JAX package's state bound for these kernels (``ops/__init__.py``
# ``_MAX_K``); the CUDA kernels take any K up to it.
MAX_K = 1024
# The prob-space kernels' state bound (the JAX package's ``LANES``).
PROB_MAX_K = 128
# The smallest positive value the prob-space chains carry, and the floor
# of their rescale and of the log they take (the TPU kernels' 1e-37).
_FLOOR = 1e-37

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("scan_bigk", {
    "scan_bigk_forward_f32": [_P] * 5 + [_I] * 4 + [_P],
    "scan_bigk_backward_f32": [_P] * 4 + [_I] * 4 + [_P],
    "scan_bigk_viterbi_f32": [_P] * 7 + [_I] * 4 + [_P],
})
_PROB_LIB = _build.Library("scan_prob", {
    "scan_prob_forward_f32": [_P] * 5 + [_I] * 5 + [_P],
    "scan_prob_backward_f32": [_P] * 4 + [_I] * 5 + [_P],
    "scan_prob_fb_f32": [_P] * 7 + [_I] * 5 + [_P],
})


def scan_supported(num_states: int) -> bool:
    """True when the dispatch sends ``num_states`` states to these
    kernels: more than the small-K kernels take, at most ``MAX_K``."""
    return MAX_SMALLK < num_states <= MAX_K


def prob_supported(num_states: int) -> bool:
    """True when the prob-space kernels take ``num_states`` states."""
    return 1 <= num_states <= PROB_MAX_K


def _check(what, log_obs, log_a, log_pi, lengths, max_states=MAX_K):
    """Validate a CUDA launch; returns ``(B, T, K, lengths)``."""
    B, T, K, lengths = check_problem(what, log_obs, log_a, log_pi, lengths, max_states=max_states)
    tensors = {"log_obs": log_obs, "log_a": log_a}
    if log_pi is not None:
        tensors["log_pi"] = log_pi
    _build.check_tensors(what, log_obs.device, **tensors)
    return B, T, K, lengths


def pallas_forward_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's prob-space step as a T-step loop."""
    pa = torch.exp(log_a)
    alpha = log_pi + log_obs[:, 0]
    out = [alpha]
    for t in range(1, log_obs.shape[1]):
        c = alpha.amax(dim=-1, keepdim=True)
        nxt = (log_obs[:, t] + c) + torch.log(torch.exp(alpha - c) @ pa)
        if lengths is not None:
            nxt = torch.where((t < lengths)[:, None], nxt, alpha)
        out.append(nxt)
        alpha = nxt
    log_alpha = torch.stack(out, 1)
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=-1)


def pallas_forward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward algorithm: ``(log_alpha (B, T, K), log_z (B,))``; with
    ``lengths (B,)`` each row's alpha is frozen from its end on, so
    ``log_z`` is the logsumexp of its last valid frame.

    CUDA tensors run the kernel (counted in ``pallas_forward.launches``):
    float32 and contiguous, ``lengths`` int32, 1 ≤ K ≤ 1024, all on one
    device; anything else raises. CPU tensors run the plain version.
    """
    if log_obs.device.type == "cpu":
        return pallas_forward_reference(log_obs, log_a, log_pi, lengths)
    B, T, K, lengths = _check("pallas_forward", log_obs, log_a, log_pi, lengths)
    pa = torch.exp(log_a).contiguous()
    alpha = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
    _LIB.launch("scan_bigk_forward_f32", "pallas_forward", log_obs, pa, log_pi, lengths, alpha,
                B, T, K)
    pallas_forward.launches += 1
    return alpha, torch.logsumexp(alpha[:, -1], dim=-1)


pallas_forward.launches = 0


def pallas_backward_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: the kernel's prob-space step as a T-step loop."""
    B, T, K = log_obs.shape
    pa_t = torch.exp(log_a).T
    beta = torch.zeros((B, K), dtype=log_obs.dtype, device=log_obs.device)
    out = [beta]
    for t in range(T - 2, -1, -1):
        v = log_obs[:, t + 1] + beta
        c = v.amax(dim=-1, keepdim=True).clamp_min(core.LOG_ZERO)
        nxt = c + torch.log(torch.exp(v - c) @ pa_t)
        if lengths is not None:
            nxt = torch.where((t < lengths - 1)[:, None], nxt, torch.zeros_like(nxt))
        out.append(nxt)
        beta = nxt
    return torch.stack(out[::-1], 1)


def pallas_backward(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward algorithm: ``log_beta (B, T, K)``, 0 from each row's
    frame ``lengths[b] - 1`` on. Launch rules as :func:`pallas_forward`
    (counted in ``pallas_backward.launches``)."""
    if log_obs.device.type == "cpu":
        return pallas_backward_reference(log_obs, log_a, lengths)
    B, T, K, lengths = _check("pallas_backward", log_obs, log_a, None, lengths)
    pa_t = torch.exp(log_a).T.contiguous()
    beta = torch.empty((B, T, K), dtype=torch.float32, device=log_obs.device)
    _LIB.launch("scan_bigk_backward_f32", "pallas_backward", log_obs, pa_t, lengths, beta, B, T, K)
    pallas_backward.launches += 1
    return beta


pallas_backward.launches = 0


def pallas_viterbi_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the ported ``core.viterbi``."""
    return core.viterbi(log_obs, log_a, log_pi, lengths)


def pallas_viterbi(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Viterbi: ``(states (B, T) int32, score (B,))``, the same
    paths and scores as ``core.viterbi``, ties and ragged padding
    included. Launch rules as :func:`pallas_forward` (counted in
    ``pallas_viterbi.launches``)."""
    if log_obs.device.type == "cpu":
        return pallas_viterbi_reference(log_obs, log_a, log_pi, lengths)
    B, T, K, lengths = _check("pallas_viterbi", log_obs, log_a, log_pi, lengths)
    dev = log_obs.device
    psi = torch.empty((B, T, K), dtype=torch.int16, device=dev)
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    _LIB.launch("scan_bigk_viterbi_f32", "pallas_viterbi", log_obs, log_a, log_pi, lengths, psi,
                states, score, B, T, K)
    pallas_viterbi.launches += 1
    return states, score


pallas_viterbi.launches = 0


# -- the long-sequence prob-space chains (rows 10-12) --------------------------


def _check_rs(what: str, rs: int) -> int:
    if int(rs) != rs or rs < 1:
        raise ValueError(f"{what}: the rescale interval rs must be a positive integer, got {rs}")
    return int(rs)


def _prob_prepass(log_obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each frame's max ``m (B, T, 1)``, floored at -1e30, and the
    shifted probabilities ``e = exp(log_obs - m)``."""
    m = log_obs.amax(dim=-1, keepdim=True).clamp_min(core.LOG_ZERO)
    return m, torch.exp(log_obs - m)


def _rescaled(q: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q / r`` and ``c + log r`` for ``r = max(max q, 1e-37)``."""
    r = q.amax(dim=-1, keepdim=True).clamp_min(_FLOOR)
    return q * (1.0 / r), c + torch.log(r)


def _forward_prob_split(log_obs, log_a, log_pi, rs):
    """The plain forward chain as ``(log(max(q_t, 1e-37)) (B, T, K),
    shift (B, T))``, log alpha their sum."""
    m, e = _prob_prepass(log_obs)
    pa = torch.exp(log_a)
    q = torch.exp(log_pi) * e[:, 0]
    c = torch.zeros_like(m[:, 0])
    qs, cs = [q], [c]
    for t in range(1, log_obs.shape[1]):
        if t % rs == 0:
            q, c = _rescaled(q, c)
        q = (q @ pa) * e[:, t]
        qs.append(q)
        cs.append(c)
    shift = torch.stack(cs, 1) + torch.cumsum(m, dim=1)
    return torch.log(torch.stack(qs, 1).clamp_min(_FLOOR)), shift[..., 0]


def _backward_prob_split(log_obs, log_a, rs):
    """The plain backward chain, which carries ``u_t = e_t ⊙ beta_t``, as
    ``(log(max(s_t, 1e-37)) (B, T, K), shift (B, T))``."""
    m, e = _prob_prepass(log_obs)
    B, T, K = log_obs.shape
    pa_t = torch.exp(log_a).T
    q = torch.ones((B, K), dtype=log_obs.dtype, device=log_obs.device)
    c = torch.zeros_like(m[:, 0])
    ss, cs = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        if t + 1 < T and (t + 1) % rs == 0:
            q, c = _rescaled(q, c)
        ss[t] = q @ pa_t
        cs[t] = c
        q = ss[t] * e[:, t]
    later = torch.flip(torch.cumsum(torch.flip(m, [1]), dim=1), [1]) - m   # Σ_{u>t} m_u
    return torch.log(torch.stack(ss, 1).clamp_min(_FLOOR)), (torch.stack(cs, 1) + later)[..., 0]


def pallas_forward_prob_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's scaled chain as a T-step loop, rescaled
    at the frames ``t % rs == 0``."""
    rel, shift = _forward_prob_split(log_obs, log_a, log_pi, _check_rs("pallas_forward_prob", rs))
    log_alpha = rel + shift[..., None]
    return log_alpha, torch.logsumexp(log_alpha[:, -1], dim=-1)


def pallas_backward_prob_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> torch.Tensor:
    """Plain version: the kernel's scaled chain, which carries ``u_t = e_t
    ⊙ beta_t``, as a T-step loop rescaled at the frames ``(t + 1) % rs ==
    0``."""
    rel, shift = _backward_prob_split(log_obs, log_a, _check_rs("pallas_backward_prob", rs))
    return rel + shift[..., None]


def pallas_fb_prob_reference(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the two plain chains."""
    log_alpha, log_z = pallas_forward_prob_reference(log_obs, log_a, log_pi, rs)
    return log_alpha, pallas_backward_prob_reference(log_obs, log_a, rs), log_z


def _prob_launch(what, entry, log_obs, log_a, log_pi, rs, chains):
    """Launch ``what``'s kernel through the C function ``entry``:
    ``chains`` relative tables (B, T, K) and as many per-frame shifts (B,
    T) out, in the C function's order."""
    B, T, K, _ = _check(what, log_obs, log_a, log_pi, None, PROB_MAX_K)
    dev = log_obs.device
    pa = torch.exp(log_a).contiguous()
    tables = [torch.empty((B, T, K), dtype=torch.float32, device=dev) for _ in range(chains)]
    shifts = [torch.empty((B, T), dtype=torch.float32, device=dev) for _ in range(chains)]
    ins = (log_obs, pa) if log_pi is None else (log_obs, pa, log_pi)
    _PROB_LIB.launch(entry, what, *ins, *tables, *shifts, B, T, K, rs)
    return tables, shifts


def pallas_forward_prob(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Long-sequence forward in scaled probability space: ``(log_alpha
    (B, T, K), log_z (B,))``, unragged. Within the envelope of the
    log-space :func:`pallas_forward` when no frame's reachable mass
    falls more than ~e^-87 within ``rs`` frames, which finite
    transitions give on emissions that do not force the mass through
    them every frame (the dispatch's gate).

    ``rs`` is the rescale interval (any positive integer; the TPU kernel
    took divisors of 128). ``precision`` is the reference's multiply
    precision; on the card every value computes in true float32
    (``precision.py``), so it is accepted and unused.

    CUDA tensors run the kernel (counted in
    ``pallas_forward_prob.launches``): float32 and contiguous, 1 ≤ K ≤
    128, all on one device; anything else raises. CPU tensors run the
    plain version.
    """
    rs = _check_rs("pallas_forward_prob", rs)
    if log_obs.device.type == "cpu":
        return pallas_forward_prob_reference(log_obs, log_a, log_pi, rs)
    (alpha,), (shift,) = _prob_launch("pallas_forward_prob", "scan_prob_forward_f32", log_obs, log_a, log_pi, rs, 1)
    pallas_forward_prob.launches += 1
    alpha += shift[..., None]
    return alpha, torch.logsumexp(alpha[:, -1], dim=-1)


pallas_forward_prob.launches = 0


def pallas_backward_prob(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> torch.Tensor:
    """Long-sequence ``log_beta (B, T, K)`` in scaled probability space,
    unragged. Arguments and launch rules as :func:`pallas_forward_prob`
    (counted in ``pallas_backward_prob.launches``)."""
    rs = _check_rs("pallas_backward_prob", rs)
    if log_obs.device.type == "cpu":
        return pallas_backward_prob_reference(log_obs, log_a, rs)
    (beta,), (shift,) = _prob_launch("pallas_backward_prob", "scan_prob_backward_f32", log_obs, log_a, None, rs, 1)
    pallas_backward_prob.launches += 1
    return beta.add_(shift[..., None])


pallas_backward_prob.launches = 0


def pallas_fb_prob_split(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    rs: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both prob-space chains in one launch, their tables split from
    their per-frame shifts: ``(rel_alpha (B, T, K), alpha_shift (B, T),
    rel_beta, beta_shift)`` with ``log_alpha = rel_alpha +
    alpha_shift[..., None]`` (beta likewise), as :func:`pallas_fb_prob`
    returns them summed.

    The relative tables keep one frame's magnitude however long the
    sequence: posteriors and ξ normalized per frame from them keep float32
    precision, where summed tables at B=32, T=131072, K=64 reach |log
    alpha| ~ 2.5e5 and round every state by up to 8e-3. Launch rules as
    :func:`pallas_forward_prob` (counted in ``pallas_fb_prob.launches``);
    CPU tensors run the plain chains."""
    rs = _check_rs("pallas_fb_prob", rs)
    if log_obs.device.type == "cpu":
        return (*_forward_prob_split(log_obs, log_a, log_pi, rs),
                *_backward_prob_split(log_obs, log_a, rs))
    (alpha, beta), (alpha_shift, beta_shift) = _prob_launch("pallas_fb_prob", "scan_prob_fb_f32", log_obs, log_a,
                                                            log_pi, rs, 2)
    pallas_fb_prob.launches += 1
    return alpha, alpha_shift, beta, beta_shift


def pallas_fb_prob(
    log_obs: torch.Tensor,
    log_a: torch.Tensor,
    log_pi: torch.Tensor,
    rs: int = 8,
    precision=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both prob-space chains in one launch: ``(log_alpha, log_beta,
    log_z)``, the tables of :func:`pallas_forward_prob` and
    :func:`pallas_backward_prob`. Arguments and launch rules as
    :func:`pallas_forward_prob` (counted in ``pallas_fb_prob.launches``)."""
    if log_obs.device.type == "cpu":
        return pallas_fb_prob_reference(log_obs, log_a, log_pi, _check_rs("pallas_fb_prob", rs))
    alpha, alpha_shift, beta, beta_shift = pallas_fb_prob_split(log_obs, log_a, log_pi, rs)
    alpha += alpha_shift[..., None]
    beta += beta_shift[..., None]
    return alpha, beta, torch.logsumexp(alpha[:, -1], dim=-1)


pallas_fb_prob.launches = 0
