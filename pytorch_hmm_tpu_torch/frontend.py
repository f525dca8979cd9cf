"""On-device audio frontend: raw PCM → log-mel features as torch ops.

Port of ``pytorch_hmm_tpu/frontend.py``. Framing runs on the device next
to the decoder, so audio-in → states-out needs no host framer:

* overlapped frames assemble from contiguous hop-row slices of the
  pre-emphasized extended chunk (no gather);
* the 512-point real FFT of each 400-sample frame is two matrix products
  against fixed cos/sin DFT tables;
* the mel filterbank is one more (257 → n_mels) product, then a log with
  a 1e-10 floor.

The products are plain ``torch.matmul`` in float32 (TF32 off on the
card), as the JAX package leaves them to XLA. The tables are built in
float64 numpy and cast to float32, exactly as the JAX package builds
them, so both packages hold the same tables.

Streaming alignment: a chunk carries ``F·hop`` new samples; the framer
keeps a ``lag·hop + 1``-sample tail (``lag = ceil((frame_len − hop) /
hop)``, 2 at the 400/160 default) so emitted frame ``j`` covers the
global samples ``[j·hop, j·hop + frame_len)``, delayed by ``lag`` frames.
The first chunk's first ``lag`` outputs are windows before the stream
start and are dropped by :class:`DeviceFramer`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "framing_tables",
    "device_frames",
    "DeviceFramer",
    "make_pcm_decode_step",
]


def _mel_weights(sample_rate, n_fft, n_mels) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2+1)``."""
    def hz2mel(h):
        return 2595.0 * np.log10(1.0 + h / 700.0)

    def mel2hz(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    mmin, mmax = hz2mel(0.0), hz2mel(sample_rate / 2)
    centers = mel2hz(mmin + (mmax - mmin) * np.arange(n_mels + 2) / (n_mels + 1))
    freqs = np.arange(n_bins) * sample_rate / n_fft
    W = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        lo, mid, hi = centers[m], centers[m + 1], centers[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        W[m] = np.maximum(0.0, np.minimum(up, down))
    return W


def framing_tables(
    sample_rate: int = 16000,
    n_fft: int = 512,
    frame_len: int = 400,
    hop: int = 160,
    n_mels: int = 80,
    *,
    device="cuda",
) -> dict:
    """Constant tables for :func:`device_frames`, on ``device``.

    ``cos``/``sin`` are the real-DFT analysis tables ``(frame_len,
    n_bins)`` over the unpadded window (zero padding adds nothing to the
    product), ``window`` the Hann window and ``mel_t`` the filterbank
    transposed to ``(n_bins, n_mels)``.
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))
              ).astype(np.float32)

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    return {
        "cos": table(np.cos(ang)),
        "sin": table(-np.sin(ang)),
        "window": table(window),
        "mel_t": table(_mel_weights(sample_rate, n_fft, n_mels).T),
        "frame_len": frame_len,
        "hop": hop,
        "lag": -(-(frame_len - hop) // hop),
    }


def device_frames(
    tail: torch.Tensor,
    chunk: torch.Tensor,
    tables: dict,
    preemphasis: float = 0.97,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of framing: ``(new_tail, (..., F, n_mels) log-mels)``.

    Args:
        tail: ``(..., lag·hop + 1)`` trailing samples of the previous
            chunk (zeros at stream start).
        chunk: ``(..., F·hop)`` new PCM samples.
    Leading dimensions are streams, framed independently.
    """
    frame_len, hop = tables["frame_len"], tables["hop"]
    F = chunk.shape[-1] // hop
    ext = torch.cat([tail, chunk], dim=-1)
    y = ext[..., 1:] - preemphasis * ext[..., :-1]           # (..., (F+lag)·hop)
    # frame_len = q·hop + r: each frame is q full hop-rows plus the first
    # r samples of the next one, so frames assemble from q+1 contiguous
    # slices of the (F+lag, hop) reshape.
    rows = y.reshape(*y.shape[:-1], -1, hop)
    q, r = divmod(frame_len, hop)
    parts = [rows[..., i:F + i, :] for i in range(q)]
    if r:
        parts.append(rows[..., q:F + q, :r])
    frames = torch.cat(parts, dim=-1) * tables["window"]
    re = frames @ tables["cos"]
    im = frames @ tables["sin"]
    power = re * re + im * im                                # (..., F, n_bins)
    logmel = torch.log(power @ tables["mel_t"] + 1e-10)
    new_tail = ext[..., chunk.shape[-1]:]
    return new_tail, logmel


class DeviceFramer:
    """Streaming framer with ``push``/``pop``, computing on ``device``.

    Feed any sample count; frames are computed ``chunk_frames`` at a time
    (``chunk_frames·hop`` samples) and popped as float32 numpy. Emitted
    frame ``j`` covers samples ``[j·hop, j·hop + frame_len)``.
    """

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 512,
        frame_len: int = 400,
        hop: int = 160,
        n_mels: int = 80,
        preemphasis: float = 0.97,
        chunk_frames: int = 160,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.tables = framing_tables(sample_rate, n_fft, frame_len, hop, n_mels,
                                     device=self.device)
        self.hop = hop
        self.frame_len = frame_len
        self.n_mels = n_mels
        self.preemphasis = preemphasis
        self.chunk_frames = chunk_frames
        self.reset()

    def reset(self):
        lag = self.tables["lag"]
        self._tail = torch.zeros((lag * self.hop + 1,), device=self.device)
        self._pending = np.zeros((0,), np.float32)
        self._skip = lag  # pre-stream windows from the zero tail

    def push(self, samples) -> int:
        samples = np.ascontiguousarray(samples, np.float32).ravel()
        self._pending = np.concatenate([self._pending, samples])
        return len(samples)

    @torch.no_grad()
    def pop(self, max_frames: int = 1 << 14) -> np.ndarray:
        """Drain ready frames → ``(n, n_mels)`` float32 log-mels."""
        out = []
        got = 0
        span = self.chunk_frames * self.hop
        while len(self._pending) >= span and got < max_frames:
            chunk = torch.from_numpy(self._pending[:span].copy()).to(self.device)
            self._pending = self._pending[span:]
            self._tail, feats = device_frames(self._tail, chunk, self.tables, self.preemphasis)
            feats = feats.cpu().numpy()
            if self._skip:
                feats = feats[self._skip:]
                self._skip = 0
            out.append(feats)
            got += len(feats)
        if not out:
            return np.zeros((0, self.n_mels), np.float32)
        return np.concatenate(out)[:max_frames]

    @property
    def is_native(self) -> bool:
        return False


def make_pcm_decode_step(
    processor,
    chunk_frames: int = 160,
    sample_rate: int = 16000,
    n_fft: int = 512,
    frame_len: int = 400,
    hop: int = 160,
    preemphasis: float = 0.97,
):
    """Framing, emission and beam decode of one stream as one step.

    Returns ``(step, carry0)``; ``step(carry, pcm_chunk)`` takes ``(F·hop,)``
    raw samples and returns ``(carry, states (F,), conf (F,), n_valid)``,
    everything on the processor's device. Only ``states[:n_valid]`` are
    meaningful: the first chunk yields ``n_valid = F − lag`` states
    because its ``lag`` leading windows would start before the stream and
    are dropped, the frame grid :class:`DeviceFramer` emits, so decoded
    state ``j`` covers the global samples ``[j·hop, j·hop + frame_len)``.
    Every later chunk has ``n_valid = F``. ``processor`` is a
    :class:`~pytorch_hmm_tpu_torch.streaming.StreamingHMMProcessor`; its
    weights, transitions and beam carry are captured when the step is
    made.
    """
    from .streaming import _beam_step, _emit

    dev = processor.device
    tables = framing_tables(sample_rate, n_fft, frame_len, hop, processor.feature_dim,
                            device=dev)
    with torch.no_grad():
        w = tuple(p.detach().clone() for p in processor._emission_weights())
        log_a = processor._log_a().detach()
    beam0 = (processor._beam_scores, processor._beam_states,
             processor._beam_paths, processor._beam_len)
    lag = tables["lag"]
    carry0 = (torch.zeros((lag * hop + 1,), device=dev),
              torch.tensor(lag, dtype=torch.int32, device=dev), beam0)
    frames = torch.arange(chunk_frames, device=dev)

    @torch.no_grad()
    def step(carry, pcm_chunk):
        tail, skip, beam = carry
        pcm_chunk = torch.as_tensor(pcm_chunk, device=dev)
        tail, feats = device_frames(tail, pcm_chunk, tables, preemphasis)
        # Drop the first chunk's pre-stream windows: the valid frames move
        # to the front and only n_valid of them are decoded, so the beam
        # history never sees the zero-tail windows.
        feats = feats[(frames + skip.long()) % chunk_frames]
        n_valid = chunk_frames - skip
        lo = _emit(feats, *w)
        beam, states, conf = _beam_step(log_a, lo, n_valid, beam)
        return (tail, torch.zeros_like(skip), beam), states, conf, n_valid

    return step, carry0
