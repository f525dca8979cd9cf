"""Real-time streaming HMM decoding.

Port of ``pytorch_hmm_tpu/streaming.py``: ``StreamingHMMProcessor``
(chunked low-latency decoding with a feature buffer, lookahead, greedy
or fixed-width beam search carrying decoder state across chunks, an
async thread wrapper, performance stats and latency tuning),
``MultiStreamDecoder`` (a fleet of streams per chunk cadence, and its
raw-PCM step), ``AdaptiveLatencyController`` and ``StreamingResult``.

The decoder steps are functions ``(carry, log-obs) → (carry, outputs)``
on an explicit carry: ``(prev, has_prev)`` for greedy, ``(scores (W,),
states (W,), paths (W, H), path_len)`` for the beam. The chunk chains run
in the hand-written kernels through ``ops.auto_greedy_chunk`` and
``ops.auto_beam_chunk_multi`` (the single stream is the fleet kernel at
N=1, as in the JAX package); the emission MLP and the per-chunk
bookkeeping are plain torch. The JAX package pads each span to a
32-frame granule to bound its recompiles; PyTorch runs eagerly, so the
port decodes the span as it is, with the same outputs on the frames it
returns.

Modules are built on the CUDA device unless ``device`` says otherwise.
"""

from __future__ import annotations

import math
import queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from . import ops

__all__ = [
    "StreamingResult",
    "StreamingHMMProcessor",
    "MultiStreamDecoder",
    "AdaptiveLatencyController",
]


@dataclass
class StreamingResult:
    """Per-chunk processing result."""

    decoded_states: Optional[torch.Tensor]
    confidence: float
    processing_time_ms: float
    buffer_size: int
    chunk_id: int
    status: str
    metadata: Dict[str, Any] = field(default_factory=dict)


def _linear(fan_in: int, fan_out: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` drawn from ``generator`` (weights ``N(0, 1/fan_in)``,
    zero bias), built on the CPU."""
    layer = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((fan_out, fan_in), generator=generator)
                           / math.sqrt(fan_in))
        layer.bias.zero_()
    return layer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamingHMMProcessor(nn.Module):
    """Streaming chunked HMM decoder.

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``; a
    fresh one seeded with 0 when omitted) and moved to ``device``. Torch
    cannot reproduce the JAX package's ``nnx.Rngs`` draws, so weights are
    carried across with ``bridge.streaming_processor_state_dict`` where
    the two must agree.
    """

    def __init__(
        self,
        num_states: int,
        feature_dim: int,
        chunk_size: int = 160,
        overlap_size: int = 80,
        lookahead_frames: int = 5,
        max_delay_frames: int = 50,
        use_beam_search: bool = True,
        beam_width: int = 8,
        buffer_size: int = 1000,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_states = num_states
        self.feature_dim = feature_dim
        self.chunk_size = chunk_size
        self.overlap_size = overlap_size
        self.lookahead_frames = lookahead_frames
        self.max_delay_frames = max_delay_frames
        self.use_beam_search = use_beam_search
        self.beam_width = min(beam_width, num_states)
        self.buffer_size = buffer_size

        self.transition_logits = nn.Parameter(
            torch.randn((num_states, num_states), generator=generator) * 0.1)
        self.emission_hidden = _linear(feature_dim, 128, generator)
        self.emission_out = _linear(128, num_states, generator)
        self.to(device)

        self.reset_streaming_state()

        # Performance monitoring (host-side).
        self.processing_times: deque = deque(maxlen=1000)
        self.emission_times: deque = deque(maxlen=1000)
        self.decode_times: deque = deque(maxlen=1000)

        # Async plumbing: a host thread and two queues.
        self.processing_queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self.result_queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self.is_processing = False
        self.processing_thread: Optional[threading.Thread] = None

    @property
    def device(self) -> torch.device:
        return self.transition_logits.device

    # -- state ---------------------------------------------------------------
    def reset_streaming_state(self):
        """Reset all carried decoder state."""
        dev = self.device
        self._buffer = np.zeros((0, self.feature_dim), np.float32)
        self.last_output_frame = -1
        self.frames_dropped = 0
        self.chunk_counter = 0
        self.total_frames_processed = 0
        # Greedy carry: previous state and whether it exists.
        self._prev_state = torch.zeros((), dtype=torch.int32, device=dev)
        self._has_prev = torch.zeros((), dtype=torch.bool, device=dev)
        # Beam carry: (W,) scores, (W,) last states, (W, H) rolling paths,
        # path length. H covers the longest decodable span (a full buffer
        # flush). The uniform prior -log S is rounded to f32 once on the
        # host.
        W = self.beam_width
        H = max(self.max_delay_frames, self.chunk_size) + self.lookahead_frames
        init = -ops.stream.log_num_states(self.num_states)
        self._beam_scores = torch.where(torch.arange(W, device=dev) < self.num_states,
                                        init, float("-inf"))
        self._beam_states = torch.arange(W, dtype=torch.int32, device=dev) % self.num_states
        self._beam_paths = torch.zeros((W, H), dtype=torch.int32, device=dev)
        self._beam_len = torch.zeros((), dtype=torch.int32, device=dev)

    def _max_buffer(self) -> int:
        # The cap must admit at least one decodable span (chunk plus
        # lookahead), as in the JAX package.
        return max(self.max_delay_frames + self.lookahead_frames,
                   self.chunk_size + self.lookahead_frames)

    # -- parameter views ------------------------------------------------------
    def get_transition_matrix(self) -> torch.Tensor:
        return torch.softmax(self.transition_logits, dim=-1)

    def _emission_log_probs(self, features: torch.Tensor) -> torch.Tensor:
        return _emit(features, *self._emission_weights())

    def _emission_weights(self):
        return (self.emission_hidden.weight, self.emission_hidden.bias,
                self.emission_out.weight, self.emission_out.bias)

    def _log_a(self) -> torch.Tensor:
        return torch.log(self.get_transition_matrix() + 1e-8)

    # -- async wrapper ---------------------------------------------------------
    def start_async_processing(self):
        if self.is_processing:
            return
        self.is_processing = True
        self.processing_thread = threading.Thread(
            target=self._async_processing_loop, daemon=True)
        self.processing_thread.start()

    def stop_async_processing(self):
        self.is_processing = False
        if self.processing_thread:
            self.processing_thread.join()

    def _async_processing_loop(self):
        while self.is_processing:
            try:
                chunk = self.processing_queue.get(timeout=0.1)
                result = self.process_chunk(chunk)
                if not self.result_queue.full():
                    self.result_queue.put(result)
                self.processing_queue.task_done()
            except queue.Empty:
                continue
            except Exception as e:  # pragma: no cover - defensive
                warnings.warn(f"Error in async processing: {e}")

    def add_audio_chunk_async(self, audio_chunk) -> bool:
        """Enqueue a chunk; ``False`` when back-pressured."""
        try:
            self.processing_queue.put_nowait(audio_chunk)
            return True
        except queue.Full:
            return False

    def get_result_async(self) -> Optional[StreamingResult]:
        try:
            return self.result_queue.get_nowait()
        except queue.Empty:
            return None

    # -- synchronous path -------------------------------------------------------
    def process_chunk(self, audio_chunk) -> StreamingResult:
        """Process one ``(chunk, feature_dim)`` block of features."""
        start_time = time.perf_counter()
        if isinstance(audio_chunk, torch.Tensor):
            audio_chunk = audio_chunk.detach().cpu().numpy()
        chunk = np.asarray(audio_chunk, np.float32)
        self._buffer = np.concatenate([self._buffer, chunk], axis=0)
        max_buf = self._max_buffer()
        if len(self._buffer) > max_buf:
            drop = len(self._buffer) - max_buf
            self._buffer = self._buffer[drop:]
            self.last_output_frame -= drop
            self.frames_dropped += drop

        available = len(self._buffer)
        required = self.chunk_size + self.lookahead_frames
        if available < required:
            ms = (time.perf_counter() - start_time) * 1e3
            return StreamingResult(None, 0.0, ms, available, self.chunk_counter, "buffering",
                                   {"frames_needed": required - available})

        start_frame = max(0, self.last_output_frame + 1)
        end_frame = available - self.lookahead_frames
        if end_frame <= start_frame:
            ms = (time.perf_counter() - start_time) * 1e3
            return StreamingResult(None, 0.0, ms, available, self.chunk_counter,
                                   "waiting_for_lookahead", {})

        features = self._buffer[start_frame:end_frame]
        states, confidence = self._decode_span(features)

        self.last_output_frame = end_frame - 1
        self.total_frames_processed += len(features)
        ms = (time.perf_counter() - start_time) * 1e3
        self.processing_times.append(ms)
        self.chunk_counter += 1

        frame_ms = len(features) * 10.0  # 100 fps features
        rtf = frame_ms / ms if ms > 0 else float("inf")
        return StreamingResult(
            states, float(torch.mean(confidence)), ms, available, self.chunk_counter, "decoded",
            {"frames_processed": len(features), "real_time_factor": rtf,
             "buffer_utilization": available / max_buf},
        )

    @torch.no_grad()
    def _decode_span(self, features: np.ndarray):
        """Emit, run the chunk step, update the carry."""
        dev = self.device
        n = len(features)
        feats = torch.from_numpy(np.ascontiguousarray(features)).to(dev)

        t0 = time.perf_counter()
        log_obs = self._emission_log_probs(feats)
        _sync(dev)
        t1 = time.perf_counter()

        log_a = self._log_a()
        if self.use_beam_search:
            carry = (self._beam_scores, self._beam_states, self._beam_paths, self._beam_len)
            new_carry, states, conf = _beam_step(log_a, log_obs, n, carry)
            (self._beam_scores, self._beam_states,
             self._beam_paths, self._beam_len) = new_carry
        else:
            carry = (self._prev_state, self._has_prev)
            new_carry, states, conf = _greedy_step(log_a, log_obs, n, carry)
            self._prev_state, self._has_prev = new_carry
        _sync(dev)
        t2 = time.perf_counter()
        self.emission_times.append((t1 - t0) * 1e3)
        self.decode_times.append((t2 - t1) * 1e3)
        return states, conf

    def flush_buffer(self) -> Optional[StreamingResult]:
        """Decode everything left in the buffer."""
        start_frame = max(0, self.last_output_frame + 1)
        if len(self._buffer) == 0 or start_frame >= len(self._buffer):
            return None
        features = self._buffer[start_frame:]
        states, confidence = self._decode_span(features)
        self.last_output_frame = len(self._buffer) - 1
        self.total_frames_processed += len(features)
        self.chunk_counter += 1
        return StreamingResult(states, float(torch.mean(confidence)), 0.0, 0,
                               self.chunk_counter, "flushed", {"final_chunk": True})

    # -- performance ------------------------------------------------------------
    def get_performance_stats(self) -> Dict[str, Any]:
        if not self.processing_times:
            return {"message": "No processing data available"}
        times = list(self.processing_times)
        avg = sum(times) / len(times)
        frame_ms = self.chunk_size * 10.0
        return {
            "total_chunks_processed": self.chunk_counter,
            "total_frames_processed": self.total_frames_processed,
            "avg_processing_time_ms": avg,
            "max_processing_time_ms": max(times),
            "min_processing_time_ms": min(times),
            "std_processing_time_ms": float(np.std(times)),
            "real_time_factor": frame_ms / avg if avg > 0 else float("inf"),
            "throughput_fps": self.total_frames_processed / (sum(times) / 1e3),
            "buffer_utilization": len(self._buffer) / self._max_buffer(),
            "chunk_size": self.chunk_size,
            "lookahead_frames": self.lookahead_frames,
            "beam_width": self.beam_width if self.use_beam_search else 1,
            "processing_mode": "beam_search" if self.use_beam_search else "greedy",
        }

    def optimize_for_latency(self, target_latency_ms: float = 50.0):
        """Tune beam width, mode and chunk size toward a latency target."""
        stats = self.get_performance_stats()
        if "avg_processing_time_ms" not in stats:
            warnings.warn("No performance data available for optimization")
            return
        current = stats["avg_processing_time_ms"]
        if current > target_latency_ms:
            if self.use_beam_search and self.beam_width > 2:
                self.beam_width -= 1
                self._resize_beam()
            elif self.use_beam_search:
                self.use_beam_search = False
            elif self.chunk_size > 80:
                self.chunk_size = max(80, int(self.chunk_size * 0.8))
        elif current < target_latency_ms * 0.5:
            if not self.use_beam_search:
                self.use_beam_search = True
                self.beam_width = min(4, self.num_states)
                self._resize_beam()
            elif self.beam_width < 8:
                self.beam_width = min(self.beam_width + 1, self.num_states)
                self._resize_beam()

    def _resize_beam(self):
        """Re-shape the beam carry after a width change, keeping the best
        hypotheses (a stable sort: equal scores keep their slot order)."""
        W = self.beam_width
        # The history length stays: chunk_size may have changed since the
        # buffers were allocated.
        H = self._beam_paths.shape[1]
        old_w = self._beam_scores.shape[0]
        if old_w == W:
            return
        if W < old_w:
            top = torch.argsort(-self._beam_scores, stable=True)[:W]
            self._beam_scores = self._beam_scores[top]
            self._beam_states = self._beam_states[top]
            self._beam_paths = self._beam_paths[top]
        else:
            pad, dev = W - old_w, self.device
            self._beam_scores = torch.cat(
                [self._beam_scores, torch.full((pad,), float("-inf"), device=dev)])
            self._beam_states = torch.cat(
                [self._beam_states, torch.zeros((pad,), dtype=torch.int32, device=dev)])
            self._beam_paths = torch.cat(
                [self._beam_paths, torch.zeros((pad, H), dtype=torch.int32, device=dev)])

    def get_latency_breakdown(self) -> Dict[str, float]:
        """Measured emission / decode split (each synchronized on CUDA)."""
        if not self.processing_times:
            return {}
        total = sum(self.processing_times) / len(self.processing_times)
        emit = sum(self.emission_times) / len(self.emission_times) if self.emission_times else 0.0
        dec = sum(self.decode_times) / len(self.decode_times) if self.decode_times else 0.0
        return {
            "emission_computation": emit,
            "viterbi_decoding": dec,
            "bookkeeping": max(total - emit - dec, 0.0),
            "total": total,
        }


# ---------------------------------------------------------------------------
# Decoder steps (carry in, carry out)
# ---------------------------------------------------------------------------


def _emit(feats, w1, b1, w2, b2):
    """Emission MLP: ``log_softmax(relu(feats @ w1.T + b1) @ w2.T + b2)``
    (``nn.Linear`` layout)."""
    h = torch.relu(torch.nn.functional.linear(feats, w1, b1))
    return torch.log_softmax(torch.nn.functional.linear(h, w2, b2), dim=-1)


def _greedy_step(log_a, log_obs, n_valid, carry):
    """Frame-greedy chunk decode: ``(carry, states (T,), conf (T,))``,
    the confidence being each frame's probability score."""
    new_carry, states, scores = ops.auto_greedy_chunk(log_a, log_obs, n_valid, carry)
    return new_carry, states, torch.exp(scores)


def _beam_step(log_a, log_obs, n_valid, carry):
    """Fixed-width beam chunk decode of one stream: the fleet decode at
    N=1, then :func:`_beam_finalize`."""
    sc, ls, pt, pl = carry
    nv = ops.stream.index_vector(n_valid, 1, log_obs.device)
    raw = ops.auto_beam_chunk_multi(log_a, log_obs[None], nv,
                                    (sc[None], ls[None], pt[None], pl.reshape(1)))
    (fsc, fls, fpt, fpl), states, conf = _beam_finalize(raw, sc[None], log_obs.shape[0], nv)
    return (fsc[0], fls[0], fpt[0], fpl.reshape(pl.shape)), states[0], conf[0]


def _beam_scan_raw(log_a, log_obs, n_valid, carry):
    """The raw beam scan of one stream, without the finalize: the plain
    fleet decode at N=1. Returns ``(scores, states, paths, path_len,
    frames)`` as the JAX package's scan carry does."""
    sc, ls, pt, pl = carry
    out = ops.beam_chunk_multi_reference(log_a, log_obs[None], n_valid,
                                         (sc[None], ls[None], pt[None], pl.reshape(1)))
    return (*(o[0] for o in out[:3]), out[3].reshape(pl.shape),
            torch.tensor(log_obs.shape[0], dtype=torch.int32))


def _beam_finalize(new_carry, scores_before, t_pad: int, n_valid: torch.Tensor):
    """Post-chunk bookkeeping of N streams: best-path extraction, per-span
    confidence, score renormalization.

    ``new_carry`` is the raw ``(N, ...)`` carry after the chunk,
    ``scores_before (N, W)`` the scores before it, ``n_valid (N,)``.
    Returns ``(carry, states (N, t_pad), conf (N, t_pad))``: the last
    ``n_valid`` states of each stream's best history at the front, then
    its last state repeated."""
    scores, last_states, paths, path_len = new_carry
    N, _, H = paths.shape
    rows = torch.arange(N, device=paths.device)
    best = torch.argmax(scores, dim=1)
    tail = paths[rows, best]                                              # (N, H)
    idx = (H - n_valid.long())[:, None] + torch.arange(t_pad, device=paths.device)[None, :]
    states = tail.gather(1, torch.clamp(idx, 0, H - 1))
    # Per-span confidence: the geometric-mean probability of the frames
    # decoded in this chunk (score delta / n_valid), so it does not decay
    # on long streams.
    span = scores[rows, best] - torch.amax(scores_before, dim=1)
    conf = torch.exp(span / torch.clamp(n_valid, min=1).to(torch.float32))
    conf = conf[:, None].expand(N, t_pad)
    # Renormalize the carried scores; only their differences matter.
    scores = scores - torch.amax(scores, dim=1, keepdim=True)
    return (scores, last_states, paths, path_len), states, conf


class MultiStreamDecoder:
    """Beam-decode N concurrent streams per chunk cadence in one kernel
    launch (one warp per stream).

    Usage::

        dec = MultiStreamDecoder(processor, n_streams=8)
        carry = dec.init_carry()
        carry, states, conf = dec.step(carry, feats)   # (N, F, D) in
        # states (N, F) int32, conf (N, F): per stream, equal to running
        # processor.process_chunk on each stream separately.

    Streams may be at different points of their lifecycle (per-stream
    history). The processor's weights and transitions are captured when
    the decoder is built. To retire a stream, reset its carry rows with
    :meth:`reset_stream`.
    """

    def __init__(self, processor: StreamingHMMProcessor, n_streams: int,
                 chunk_frames: Optional[int] = None):
        self.n = int(n_streams)
        self.chunk_frames = chunk_frames or processor.chunk_size
        self.num_states = processor.num_states
        self.beam_width = processor.beam_width
        self.history = processor._beam_paths.shape[1]
        self.device = processor.device
        with torch.no_grad():
            self._w = tuple(p.detach().clone() for p in processor._emission_weights())
            self._log_a = processor._log_a().detach()
        self._proto = (processor._beam_scores, processor._beam_states,
                       processor._beam_paths, processor._beam_len)
        self._pcm_lag: Optional[int] = None

    def init_carry(self):
        """Stacked fresh per-stream beam carries."""
        sc, st, pt, pl_ = self._proto
        N = self.n
        return (sc.expand(N, *sc.shape).clone(), st.expand(N, *st.shape).clone(),
                pt.expand(N, *pt.shape).clone(),
                torch.zeros((N,), dtype=torch.int32, device=self.device))

    def reset_stream(self, carry, i: int):
        """Fresh carry for stream ``i`` (session ended / new session).

        Takes the beam carry of :meth:`step`, or the carry of the PCM step
        from :meth:`make_pcm_step`; of the latter it also zeroes the
        stream's framer tail and re-arms its own skip counter, so the
        stream's next chunk drops its pre-stream windows."""
        if len(carry) == 3:
            tails, skips, beam = carry
            tails, skips = tails.clone(), skips.clone()
            tails[i] = 0.0
            skips[i] = self._pcm_lag
            return tails, skips, self.reset_stream(beam, i)
        sc, st, pt, _ = self._proto
        c0, c1, c2, c3 = (c.clone() for c in carry)
        c0[i], c1[i], c2[i], c3[i] = sc, st, pt, 0
        return c0, c1, c2, c3

    @torch.no_grad()
    def step(self, carry, features: torch.Tensor, n_valid=None):
        """One chunk for every stream: ``features (N, F, D)`` →
        ``(carry, states (N, F), conf (N, F))``. ``n_valid`` (an int, or
        ``(N,)`` per stream; default F) counts the frames that advance
        each stream."""
        features = torch.as_tensor(features, device=self.device)
        nv = features.shape[1] if n_valid is None else n_valid
        return _multi_step(self._log_a, self._w, nv, carry, features)

    # -- raw-audio serving: on-device framing for every stream ---------
    def make_pcm_step(self, sample_rate=16000, n_fft=512, frame_len=400, hop=160,
                      preemphasis=0.97, feature_dim=None):
        """Whole-fleet audio→states: ``step(carry, pcm (N, F·hop))`` →
        ``(carry, states (N, F), conf (N, F), n_valid (N,))``.

        The matmul-DFT frontend (``frontend.device_frames``) frames every
        stream and feeds the fleet beam kernel. Returns ``(step, carry0)``;
        the carry is ``(framer tails (N, lag·hop + 1), skip counters (N,),
        beam carry)``. Only ``states[n, :n_valid[n]]`` are meaningful: a
        stream's first chunk yields ``F − lag`` states (its ``lag``
        leading windows would start before the stream and are dropped,
        the ``DeviceFramer`` frame grid), later chunks ``F``. Each stream
        keeps its own skip counter, which :meth:`reset_stream` re-arms."""
        from .frontend import device_frames, framing_tables

        n_mels = feature_dim or self._w[0].shape[1]
        tables = framing_tables(sample_rate, n_fft, frame_len, hop, n_mels, device=self.device)
        lag = tables["lag"]
        self._pcm_lag = lag
        F, dev = self.chunk_frames, self.device
        carry0 = (torch.zeros((self.n, lag * hop + 1), device=dev),
                  torch.full((self.n,), lag, dtype=torch.int32, device=dev),
                  self.init_carry())
        log_a, w = self._log_a, self._w
        frames = torch.arange(F, device=dev)

        @torch.no_grad()
        def step(carry, pcm):
            tails, skip, beam = carry
            pcm = torch.as_tensor(pcm, device=dev)
            tails, feats = device_frames(tails, pcm, tables, preemphasis)
            # Drop each stream's pre-stream windows: its valid frames move
            # to the front and only n_valid of them are decoded.
            idx = (frames[None, :] + skip[:, None].long()) % F
            feats = feats.gather(1, idx[:, :, None].expand(-1, -1, feats.shape[2]))
            n_valid = F - skip
            beam, states, conf = _multi_step(log_a, w, n_valid, beam, feats)
            return (tails, torch.zeros_like(skip), beam), states, conf, n_valid

        return step, carry0


def _multi_step(log_a, w, n_valid, carry, features):
    N, F, _D = features.shape
    lo = _emit(features.reshape(N * F, -1), *w).reshape(N, F, -1)
    nv = ops.stream.index_vector(n_valid, N, features.device)
    raw = ops.auto_beam_chunk_multi(log_a, lo, nv, carry)
    return _beam_finalize(raw, carry[0], F, nv)


class AdaptiveLatencyController:
    """Feedback controller over recent chunk latencies."""

    def __init__(
        self,
        initial_chunk_size: int = 160,
        min_chunk_size: int = 80,
        max_chunk_size: int = 320,
        target_latency_ms: float = 50.0,
        adaptation_rate: float = 0.1,
    ):
        self.chunk_size = initial_chunk_size
        self.min_chunk_size = min_chunk_size
        self.max_chunk_size = max_chunk_size
        self.target_latency_ms = target_latency_ms
        self.adaptation_rate = adaptation_rate
        self.latency_history: deque = deque(maxlen=100)
        self.last_adjustment_time = 0.0

    def update(self, processing_time_ms: float, buffer_size: int) -> Dict[str, Any]:
        """Feed one latency sample; returns recommended parameter changes
        (1 s cooldown between adjustments)."""
        self.latency_history.append(processing_time_ms)
        now = time.time()
        if now - self.last_adjustment_time < 1.0:
            return {}
        if len(self.latency_history) < 10:
            return {}

        recent = list(self.latency_history)[-20:]
        avg = sum(recent) / len(recent)
        var = float(np.var(recent))
        rec: Dict[str, Any] = {}

        if avg > self.target_latency_ms * 1.2:
            if self.chunk_size > self.min_chunk_size:
                self.chunk_size = max(self.min_chunk_size,
                                      int(self.chunk_size * (1 - self.adaptation_rate)))
                rec["chunk_size"] = self.chunk_size
            rec["beam_width"] = 3
            rec["use_beam_search"] = avg <= self.target_latency_ms * 2
        elif avg < self.target_latency_ms * 0.6 and var < 10.0:
            if self.chunk_size < self.max_chunk_size and buffer_size > 100:
                self.chunk_size = min(self.max_chunk_size,
                                      int(self.chunk_size * (1 + self.adaptation_rate)))
                rec["chunk_size"] = self.chunk_size
            rec["beam_width"] = 6
            rec["use_beam_search"] = True
        elif var > 25.0:
            rec["use_beam_search"] = False
            self.chunk_size = max(self.min_chunk_size, int(self.chunk_size * 0.9))
            rec["chunk_size"] = self.chunk_size

        if rec:
            self.last_adjustment_time = now
        return rec
