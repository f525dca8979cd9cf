"""Neural gaussian emission: the MLP trunk and gaussian head of every
state, with one read of the observations.

Port of ``pytorch_hmm_tpu/ops/emit_mlp.py``::

    h1 = relu(x W1 + b1);  h2 = relu(h1 W2 + b2)
    mo = h2 Wm + bm;       lvo = h2 Wlv + blv
    u  = (x − mo) − center;          wo = exp(−lvo)
    out[s] = (state_const[s] − ½·D·log 2π) − ½·Σ lvo
             − ½·max(u²wo·A_s − 2·uwo·B_s + wo·C_s, 0)

with the per-state tables ``A = wsᵀ``, ``B = (msc·ws)ᵀ``, ``C =
(msc²·ws)ᵀ`` and ``center`` computed from the parameters
(:func:`gaussian_tables`). On CUDA tensors :func:`fused_gaussian_emission`
launches the hand-written kernel in ``csrc/emit_mlp.cu`` (true float32,
every activation in shared memory); on CPU tensors it runs
:func:`fused_gaussian_emission_reference`, the plain version the kernel
is held against. Either way it is a ``torch.autograd.Function``
differentiable in all 14 inputs: the JAX kernel has no VJP, and its
gradients are XLA's of the plain form, so the backward recomputes the
plain version and differentiates it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "fused_emission_supported",
    "fused_gaussian_emission",
    "fused_gaussian_emission_reference",
    "gaussian_head",
    "gaussian_tables",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = _build.Library("emit_mlp", {"emit_mlp_f32": [_P] * 15 + [_L, _I, _I, _I, _I, _P]})

# The kernel's tiling (csrc/emit_mlp.cu): 64-row tiles, features padded
# to 16, activations feature-major at a row stride of 68 floats, three
# staged 16 x 64 table slices. A block may use 227 KB of shared memory.
_ROWS, _PAD, _LD, _STAGE = 64, 16, 68, 3 * 16 * 64
_SMEM_LIMIT = 232_448


def _smem_bytes(D: int, H: int) -> int:
    dp = -(-D // _PAD) * _PAD
    hp = -(-H // _PAD) * _PAD
    return 4 * (_LD * (dp + max(hp, 2 * dp) + hp) + _STAGE + _ROWS)


def fused_emission_supported(D: int, H: int, S: int) -> bool:
    """True when the CUDA kernel takes ``D`` features, ``H`` hidden units
    and ``S`` states: a 64-row tile of the observations and of both
    hidden activations must fit one block's shared memory (H ≤ 352 at
    D = 80). ``S`` is walked in column passes and takes any value ≥ 1."""
    return D >= 1 and H >= 1 and S >= 1 and _smem_bytes(D, H) <= _SMEM_LIMIT


def gaussian_tables(emb: torch.Tensor, wm: torch.Tensor, wlv: torch.Tensor):
    """The per-state tables of the centred expansion from the state
    embeddings ``(S, H)`` and the head kernels ``(H, D)`` (``(in, out)``
    layout): ``(ws_t, mw_t, mmw_t)`` ``(D, S)``, ``state_const (S,) =
    −½·Σ lvs_s`` and ``center (D,)``, the mean of the state means."""
    ms = emb @ wm
    lvs = emb @ wlv
    center = torch.mean(ms, dim=0)
    msc = ms - center
    ws = torch.exp(-lvs)
    return ws.T, (msc * ws).T, (msc * msc * ws).T, -0.5 * torch.sum(lvs, dim=-1), center


def gaussian_head(x, mo, lvo, ws_t, mw_t, mmw_t, state_const, center):
    """Every state's gaussian score ``(..., S)`` of ``x (..., D)`` from the
    observation part of the head (``mo``, ``lvo`` ``(..., D)``, biases
    included) and :func:`gaussian_tables`: the centred expansion
    ``Σ(u − m_s)²·w·w_s = u²w·A_s − 2·uw·B_s + w·C_s`` with ``u = x − mo −
    center``, clamped at 0."""
    D = x.shape[-1]
    u = (x - mo) - center
    wo = torch.exp(-lvo)
    uw = u * wo
    mahal = torch.clamp((u * uw) @ ws_t - 2.0 * (uw @ mw_t) + wo @ mmw_t, min=0.0)
    const = state_const - 0.5 * D * math.log(2.0 * math.pi)
    return (const + (-0.5 * torch.sum(lvo, dim=-1, keepdim=True))) - 0.5 * mahal


def fused_gaussian_emission_reference(obs, w1, b1, w2, b2, wm, bm, wlv, blv,
                                      ws_t, mw_t, mmw_t, state_const, center):
    """Plain torch version: the trunk, the two head products and
    :func:`gaussian_head`."""
    h = torch.relu(obs @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    return gaussian_head(obs, h @ wm + bm, h @ wlv + blv, ws_t, mw_t, mmw_t, state_const, center)


def _launch(obs, w1, b1, w2, b2, wm, bm, wlv, blv, ws_t, mw_t, mmw_t, state_const, center):
    """One launch of the CUDA kernel (counted in
    ``fused_gaussian_emission.launches``)."""
    if obs.ndim != 3:
        raise ValueError(f"fused_gaussian_emission: obs must be (B, T, D), got {tuple(obs.shape)}")
    B, T, D = obs.shape
    H, S = w1.shape[-1], ws_t.shape[-1]
    shapes = {"w1": (w1, (D, H)), "b1": (b1, (H,)), "w2": (w2, (H, H)), "b2": (b2, (H,)),
              "wm": (wm, (H, D)), "bm": (bm, (D,)), "wlv": (wlv, (H, D)), "blv": (blv, (D,)),
              "ws_t": (ws_t, (D, S)), "mw_t": (mw_t, (D, S)), "mmw_t": (mmw_t, (D, S)),
              "state_const": (state_const, (S,)), "center": (center, (D,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_gaussian_emission: {name} must be {want} at D={D}, H={H}, "
                             f"S={S}, got {tuple(t.shape)}")
    if B * T == 0:
        raise ValueError(f"fused_gaussian_emission: empty input {tuple(obs.shape)}")
    if not fused_emission_supported(D, H, S):
        raise ValueError(f"fused_gaussian_emission: D={D}, H={H} needs "
                         f"{_smem_bytes(D, H)} bytes of shared memory, over {_SMEM_LIMIT}")
    _build.check_tensors("fused_gaussian_emission", obs.device, obs=obs,
                         **{name: t for name, (t, _) in shapes.items()})
    out = torch.empty((B, T, S), dtype=torch.float32, device=obs.device)
    _LIB.launch("emit_mlp_f32", "fused_gaussian_emission", obs, w1, b1, w2, b2, wm, bm, wlv, blv,
                ws_t, mw_t, mmw_t, state_const, center, out, B * T, D, H, S)
    fused_gaussian_emission.launches += 1
    return out


class _FusedGaussianEmission(torch.autograd.Function):
    """The kernel (or, on CPU tensors, the plain version) forward; the
    backward recomputes the plain version and differentiates it, as XLA
    differentiates the JAX package's plain form."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if args[0].device.type == "cpu":
            return fused_gaussian_emission_reference(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n) for a, n in zip(args, need)]
            out = fused_gaussian_emission_reference(*inputs)
            wrt = [a for a, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return tuple(next(grads) if n else None for n in need)


def fused_gaussian_emission(
    obs: torch.Tensor,            # (B, T, D)
    w1, b1, w2, b2,               # trunk: (D, H), (H,), (H, H), (H,)
    wm, bm, wlv, blv,             # heads: (H, D), (D,), (H, D), (D,)
    ws_t, mw_t, mmw_t,            # (D, S) tables: wsᵀ, (msc·ws)ᵀ, (msc²·ws)ᵀ
    state_const,                  # (S,)  −½·Σ lvs_s
    center,                       # (D,)
) -> torch.Tensor:
    """``(B, T, S)`` gaussian head scores of every state, differentiable
    in all 14 inputs; the JAX signature and layout (``(in, out)``
    kernels, ``(D, S)`` tables).

    CUDA tensors run the kernel (counted in
    ``fused_gaussian_emission.launches``) and must be float32, contiguous,
    on one device and inside :func:`fused_emission_supported`; anything
    else raises. CPU tensors run the plain version.
    """
    return _FusedGaussianEmission.apply(obs, w1, b1, w2, b2, wm, bm, wlv, blv,
                                        ws_t, mw_t, mmw_t, state_const, center)


fused_gaussian_emission.launches = 0
