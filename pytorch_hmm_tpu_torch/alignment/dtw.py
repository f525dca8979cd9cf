"""Dynamic time warping: distance matrices, hard DTW paths and costs,
soft-DTW, the aligner modules and the phoneme-audio helpers.

Port of ``pytorch_hmm_tpu/alignment/dtw.py``. The hard recurrence runs
over anti-diagonals (``ops.dtw``): on CUDA tensors inside
``ops.dtw.pallas_dtw_supported`` :func:`dtw_path_padded` and
:func:`dtw_distance` launch the wavefront-and-backtrace kernel of
``csrc/dtw.cu`` (one launch per pair); other shapes on the card, and
every CPU tensor, run the plain wavefront here, which is the JAX
package's XLA scan on every backend. Both give the same bits.
:func:`compute_dtw_path` returns the whole cost matrix, so it runs the
plain wavefront on every device, as the reference does. Soft-DTW has no
kernel in either package: plain torch, differentiated by autograd.

The free functions run on their inputs' device; the aligner modules,
which hold no parameters, move their inputs to theirs.

As in the reference, ``ConstrainedDTWAligner`` applies its Sakoe-Chiba
band, soft-DTW's alignment is the gradient of the smoothed cost with
respect to the distance matrix, and ``asymmetric`` is the same
recurrence as ``symmetric``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.semiring import logsumexp
from ..ops.dtw import dtw_backtrace as _backtrace
from ..ops.dtw import dtw_wavefront as _dtw_wavefront
from ..ops.dtw import pallas_dtw, pallas_dtw_supported

__all__ = [
    "compute_distance_matrix",
    "compute_dtw_path",
    "dtw_path_padded",
    "dtw_distance",
    "dtw_alignment",
    "soft_dtw",
    "soft_dtw_alignment",
    "DTWAligner",
    "ConstrainedDTWAligner",
    "phoneme_audio_alignment",
    "extract_phoneme_durations",
]

_INF = float("inf")
# Soft-DTW's stand-in for +inf: finite, so the soft minimum and its
# gradient stay finite.
_BIG = 1e30


def compute_distance_matrix(x: torch.Tensor, y: torch.Tensor,
                            distance_fn: str = "euclidean") -> torch.Tensor:
    """Pairwise distances ``(N, M)`` between ``x (N, D)`` and ``y (M, D)``:
    ``euclidean`` and ``cosine`` through one matrix product, ``manhattan``
    elementwise."""
    if distance_fn == "euclidean":
        # ||a - b||² = ||a||² + ||b||² - 2ab: one product and rank-1 terms.
        x2 = torch.sum(x * x, dim=-1)[:, None]
        y2 = torch.sum(y * y, dim=-1)[None, :]
        sq = torch.clamp_min(x2 + y2 - 2.0 * (x @ y.T), 0.0)
        return torch.sqrt(sq + 1e-12)
    if distance_fn == "cosine":
        xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8)
        yn = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + 1e-8)
        return 1.0 - xn @ yn.T
    if distance_fn == "manhattan":
        return torch.sum(torch.abs(x[:, None] - y[None, :]), dim=-1)
    raise ValueError(f"Unknown distance function: {distance_fn}")


# ---------------------------------------------------------------------------
# Hard DTW
# ---------------------------------------------------------------------------

def _use_dtw_kernel(dist: torch.Tensor) -> bool:
    """True when ``dist`` goes to the kernel: any device but the CPU (CUDA,
    or a device the kernel then refuses) inside its envelope."""
    return dist.device.type != "cpu" and pallas_dtw_supported(*dist.shape)


def _kernel(dist: torch.Tensor, step_pattern: str):
    # The reference's kernel casts to float32 too.
    return pallas_dtw(dist.float().contiguous(), step_pattern)


def compute_dtw_path(distance_matrix: torch.Tensor, step_pattern: str = "symmetric"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(path_i, path_j, cost_matrix (N, M))``, the path trimmed to its
    length on the host (:func:`dtw_path_padded` keeps it on the device)."""
    cost, choices = _dtw_wavefront(distance_matrix, step_pattern)
    pi, pj, length = _backtrace(choices)
    n_pad = pi.shape[0] - int(length)
    return pi[n_pad:], pj[n_pad:], cost


def dtw_path_padded(dist: torch.Tensor, step_pattern: str = "symmetric"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(path_i, path_j, length, final_cost)`` with no read back to the
    host: paths of N+M-1 entries whose leading ones are frozen at (0, 0),
    the true path being the last ``length``. The kernel on CUDA tensors
    inside its envelope, the plain wavefront elsewhere; the same bits."""
    if _use_dtw_kernel(dist):
        return _kernel(dist, step_pattern)
    cost, choices = _dtw_wavefront(dist, step_pattern)
    pi, pj, length = _backtrace(choices)
    return pi, pj, length, cost[-1, -1]


def dtw_distance(x: torch.Tensor, y: torch.Tensor, distance_fn: str = "euclidean",
                 step_pattern: str = "symmetric") -> torch.Tensor:
    """Scalar DTW distance between ``x (N, D)`` and ``y (M, D)``."""
    dist = compute_distance_matrix(x, y, distance_fn)
    if _use_dtw_kernel(dist):
        return _kernel(dist, step_pattern)[3]
    cost, _ = _dtw_wavefront(dist, step_pattern)
    return cost[-1, -1]


def dtw_alignment(x: torch.Tensor, y: torch.Tensor, distance_fn: str = "euclidean",
                  step_pattern: str = "symmetric"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(path_i, path_j, total_cost)``, the path trimmed to its length
    (one read back to the host)."""
    dist = compute_distance_matrix(x, y, distance_fn)
    pi, pj, length, cost = dtw_path_padded(dist, step_pattern)
    n_pad = pi.shape[0] - int(length)
    return pi[n_pad:], pj[n_pad:], cost


# ---------------------------------------------------------------------------
# Soft-DTW (Cuturi & Blondel 2017)
# ---------------------------------------------------------------------------

def _soft_dtw_from_dist(dist: torch.Tensor, gamma: float) -> torch.Tensor:
    """Smoothed DTW cost: the wavefront with a soft minimum."""
    N, M = dist.shape
    dev = dist.device
    i_idx = torch.arange(N, device=dev)
    big_row = torch.full((N,), _BIG, dtype=dist.dtype, device=dev)
    big1 = big_row[:1]
    d1, d2 = big_row, big_row
    for k in range(N + M - 1):
        j = k - i_idx
        valid = (j >= 0) & (j < M)
        dk = torch.where(valid, dist[i_idx, j.clamp(0, M - 1)], torch.zeros_like(big_row))
        cands = torch.stack([torch.cat([big1, d2[:-1]]), torch.cat([big1, d1[:-1]]), d1])
        val = dk + (-gamma * logsumexp(-cands / gamma, dim=0))
        if k == 0:
            val = torch.where(i_idx == 0, dk, val)
        val = torch.where(valid, val, big_row)
        d1, d2 = val, d1
    return d1[-1]


def soft_dtw(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.1,
             distance_fn: str = "euclidean") -> torch.Tensor:
    """Differentiable soft-DTW loss."""
    return _soft_dtw_from_dist(compute_distance_matrix(x, y, distance_fn), gamma)


def _soft_alignment(dist: torch.Tensor, gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(∂cost/∂dist, cost)`` at ``dist``, neither recording a gradient."""
    with torch.enable_grad():
        d = dist.detach().requires_grad_(True)
        cost = _soft_dtw_from_dist(d, gamma)
        (grad,) = torch.autograd.grad(cost, d)
    return grad, cost.detach()


def soft_dtw_alignment(x: torch.Tensor, y: torch.Tensor, gamma: float = 0.1,
                       distance_fn: str = "euclidean") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(expected_alignment (N, M), soft_cost)``: the expected alignment
    is ``∂cost/∂dist``, the exact soft-DTW occupation matrix, by autograd
    through the wavefront."""
    return _soft_alignment(compute_distance_matrix(x, y, distance_fn), gamma)


# ---------------------------------------------------------------------------
# Aligner modules
# ---------------------------------------------------------------------------

class DTWAligner(nn.Module):
    """DTW aligner. It has no parameters; its inputs move to its device
    (the CUDA device unless ``device`` names another; ``.to()`` moves
    it). Batched ``(B, N, D)`` inputs align pair by pair."""

    def __init__(self, distance_fn: str = "euclidean", step_pattern: str = "symmetric",
                 bandwidth: Optional[int] = None, soft_dtw: bool = False, gamma: float = 0.1,
                 device="cuda"):
        super().__init__()
        self.distance_fn = distance_fn
        self.step_pattern = step_pattern
        self.bandwidth = bandwidth
        self.use_soft_dtw = soft_dtw
        self.gamma = gamma
        self.register_buffer("_anchor", torch.empty(0, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _distance(self, x, y):
        dist = compute_distance_matrix(x, y, self.distance_fn)
        if self.bandwidth is not None:
            dist = _bandwidth_mask(dist, self.bandwidth)
        return dist

    def _align_single(self, x, y):
        dist = self._distance(x, y)
        if self.use_soft_dtw:
            align, cost = _soft_alignment(dist, self.gamma)
            # Hard path from the expected alignment: each frame's argmax.
            pi = torch.arange(x.shape[0], dtype=torch.int32, device=dist.device)
            return pi, torch.argmax(align, dim=1).int(), cost
        pi, pj, length, cost = dtw_path_padded(dist, self.step_pattern)
        n_pad = pi.shape[0] - int(length)
        return pi[n_pad:], pj[n_pad:], cost

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        """``(path_i, path_j, cost)``; for batched input, lists of paths and
        the stacked costs."""
        x = torch.as_tensor(x).to(self.device)
        y = torch.as_tensor(y).to(self.device)
        if x.ndim == 3:
            paths_i, paths_j, costs = [], [], []
            for b in range(x.shape[0]):
                pi, pj, c = self._align_single(x[b], y[b])
                paths_i.append(pi)
                paths_j.append(pj)
                costs.append(c)
            return paths_i, paths_j, torch.stack(costs)
        return self._align_single(x, y)


def _bandwidth_mask(dist: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """Sakoe-Chiba band around the stretched diagonal: cells with
    ``|i - j·N/M| > bandwidth`` become ``+inf``. ``j·N/M`` in float32, as
    the reference computes it."""
    N, M = dist.shape
    i = torch.arange(N, device=dist.device)[:, None].float()
    j = torch.arange(M, device=dist.device)[None, :]
    off_band = torch.abs(i - (j * N).float() / float(M)) > bandwidth
    return torch.where(off_band, torch.full_like(dist, _INF), dist)


class ConstrainedDTWAligner(DTWAligner):
    """DTW with an enforced Sakoe-Chiba bandwidth."""

    def __init__(self, bandwidth: int = 10, monotonic: bool = True, device="cuda", **kwargs):
        super().__init__(bandwidth=bandwidth, device=device, **kwargs)
        self.monotonic = monotonic  # standard DTW steps are monotonic


# ---------------------------------------------------------------------------
# Speech-specific helpers
# ---------------------------------------------------------------------------

def phoneme_audio_alignment(phoneme_features: torch.Tensor, audio_features: torch.Tensor,
                            phoneme_durations: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-level phoneme alignment and boundaries: ``(alignment
    (num_frames,), boundaries (num_phonemes + 1,))`` int32 on the inputs'
    device (cosine distances, the ``asymmetric`` pattern)."""
    dev = torch.as_tensor(phoneme_features).device
    aligner = DTWAligner(distance_fn="cosine", step_pattern="asymmetric", device=dev)
    path_i, path_j, _ = aligner(phoneme_features, audio_features)

    num_frames = audio_features.shape[0]
    pi = path_i.cpu().numpy()
    pj = path_j.cpu().numpy()
    alignment = np.zeros(num_frames, dtype=np.int32)
    alignment[np.clip(pj, 0, num_frames - 1)] = pi
    # Monotone fill for any frame the path skipped.
    alignment = np.maximum.accumulate(alignment)

    boundaries = [0]
    current = 0
    for frame, ph in zip(pj, pi):
        if ph > current:
            boundaries.append(int(frame))
            current = int(ph)
    boundaries.append(num_frames)
    return (torch.as_tensor(alignment, device=dev),
            torch.as_tensor(boundaries, dtype=torch.int32, device=dev))


def extract_phoneme_durations(alignment: torch.Tensor, num_phonemes: int) -> torch.Tensor:
    """Per-phoneme frame counts ``(num_phonemes,)`` int32 of a frame
    alignment (ids outside ``[0, num_phonemes)`` count nowhere)."""
    ids = torch.arange(num_phonemes, device=alignment.device)
    return (alignment[:, None] == ids[None, :]).sum(dim=0).int()
