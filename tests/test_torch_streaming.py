"""The streaming slice of the torch port against the JAX package:
``StreamingHMMProcessor`` (greedy and beam, chunk by chunk through
``process_chunk`` and ``flush_buffer``), ``MultiStreamDecoder`` (``step``,
``reset_stream``, ``make_pcm_step``), ``make_pcm_decode_step``, and the
on-device frontend (``framing_tables``, ``device_frames``,
``DeviceFramer``), with the same weights carried across by ``bridge`` and
the same numpy inputs; then the port's own state machine, stats, async
round trip and latency controller.

Both sides run float32 on the CPU (the JAX package its XLA scans, the
port its plain versions). Tolerances: the two emission MLPs round
differently in their last bits, so decoded states must agree on at
least 99.9% of frames and confidences within 1e-5; framing tables are
identical; features within rtol 2e-4 and atol 2e-3, as the JAX package's
own frontend test holds its framer to the native one.
"""

import inspect
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu import frontend as jax_frontend
from pytorch_hmm_tpu.streaming import MultiStreamDecoder as JaxFleet
from pytorch_hmm_tpu.streaming import StreamingHMMProcessor as JaxProcessor
from pytorch_hmm_tpu_torch import (
    AdaptiveLatencyController,
    DeviceFramer,
    MultiStreamDecoder,
    StreamingHMMProcessor,
    StreamingResult,
    bridge,
    device_frames,
    framing_tables,
    make_pcm_decode_step,
)

AGREE = 0.999
CONF_ATOL = 1e-5
FEAT = dict(rtol=2e-4, atol=2e-3)


def _params(model) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _pair(**kw):
    jp = JaxProcessor(rngs=nnx.Rngs(0), **kw)
    tp = StreamingHMMProcessor(device="cpu", **kw)
    tp.load_state_dict(bridge.streaming_processor_state_dict(_params(jp)))
    return jp, tp


def _agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a == b).mean()) if a.size else 1.0


def test_bridge_round_trip():
    jp, tp = _pair(num_states=5, feature_dim=7, chunk_size=8)
    back = bridge.streaming_processor_numpy(tp)
    want = _params(jp)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert tuple(tp.emission_hidden.weight.shape) == (128, 7)


@pytest.mark.parametrize("use_beam", [False, True])
def test_processor_chunks_and_flush_match_jax(use_beam):
    kw = dict(num_states=12, feature_dim=16, chunk_size=20, lookahead_frames=5,
              max_delay_frames=50, use_beam_search=use_beam, beam_width=6)
    jp, tp = _pair(**kw)
    rng = np.random.default_rng(1)
    states_j, states_t, n_decoded = [], [], 0
    for size in [7, 20, 20, 13, 40, 20, 20, 9, 20, 33]:
        chunk = rng.normal(size=(size, 16)).astype(np.float32)
        rj, rt = jp.process_chunk(chunk), tp.process_chunk(chunk)
        assert (rt.status, rt.buffer_size, rt.chunk_id) == (rj.status, rj.buffer_size, rj.chunk_id)
        assert isinstance(rt, StreamingResult)
        if rj.decoded_states is not None:
            assert rt.decoded_states.dtype == torch.int32
            states_j.append(np.asarray(rj.decoded_states))
            states_t.append(rt.decoded_states.numpy())
            n_decoded += len(states_t[-1])
            assert abs(rt.confidence - rj.confidence) <= CONF_ATOL
            assert rt.metadata["frames_processed"] == rj.metadata["frames_processed"]
    fj, ft = jp.flush_buffer(), tp.flush_buffer()
    assert ft.status == fj.status == "flushed"
    states_j.append(np.asarray(fj.decoded_states))
    states_t.append(ft.decoded_states.numpy())
    assert abs(ft.confidence - fj.confidence) <= CONF_ATOL
    assert tp.flush_buffer() is None and jp.flush_buffer() is None
    assert _agreement(np.concatenate(states_t), np.concatenate(states_j)) >= AGREE
    assert n_decoded > 100
    assert tp.total_frames_processed == jp.total_frames_processed
    assert tp.frames_dropped == jp.frames_dropped


def _feats(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def test_fleet_step_matches_jax_and_the_single_stream():
    N, F, D = 3, 16, 20
    jp, tp = _pair(num_states=8, feature_dim=D, chunk_size=F)
    jd, td = JaxFleet(jp, n_streams=N, chunk_frames=F), MultiStreamDecoder(tp, N, F)
    cj, ct = jd.init_carry(), td.init_carry()
    singles = [_pair(num_states=8, feature_dim=D, chunk_size=F, lookahead_frames=0)[1]
               for _ in range(N)]
    rng = np.random.default_rng(2)
    for nv in (None, F, 11):
        feats = _feats(rng, (N, F, D))
        cj, sj, fj = jd.step(cj, jnp.asarray(feats), n_valid=nv)
        ct, st, ft = td.step(ct, feats, n_valid=nv)
        assert st.shape == (N, F) and st.dtype == torch.int32
        assert _agreement(st, sj) >= AGREE
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=CONF_ATOL)
        np.testing.assert_array_equal(ct[3].numpy(), np.asarray(cj[3]))
        if nv is None:
            # Each stream equals the port's own processor on that stream.
            for n, p in enumerate(singles):
                r = p.process_chunk(feats[n])
                np.testing.assert_array_equal(st[n].numpy(), r.decoded_states.numpy())


def test_reset_stream_matches_jax():
    jp, tp = _pair(num_states=6, feature_dim=8, chunk_size=16)
    jd, td = JaxFleet(jp, n_streams=2, chunk_frames=16), MultiStreamDecoder(tp, 2, 16)
    feats = _feats(np.random.default_rng(3), (2, 16, 8))
    cj, _, _ = jd.step(jd.init_carry(), jnp.asarray(feats))
    ct, _, _ = td.step(td.init_carry(), feats)
    rj, rt = jd.reset_stream(cj, 1), td.reset_stream(ct, 1)
    assert int(rt[3][1]) == 0 and int(rt[3][0]) > 0
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
    np.testing.assert_array_equal(rt[2][0].numpy(), ct[2][0].numpy())
    assert int(ct[3][1]) > 0, "reset_stream must not change the carry it was given"


def test_pcm_fleet_matches_jax():
    N, F = 2, 16
    jp, tp = _pair(num_states=8, feature_dim=80, chunk_size=F)
    j_step, cj = JaxFleet(jp, n_streams=N, chunk_frames=F).make_pcm_step()
    t_step, ct = MultiStreamDecoder(tp, N, F).make_pcm_step()
    pcm = np.random.default_rng(4).standard_normal((N, F * 160)).astype(np.float32)
    for k in range(3):
        cj, sj, fj, nj = j_step(cj, jnp.asarray(pcm))
        ct, st, ft, nt = t_step(ct, pcm)
        assert nt.tolist() == [int(nj)] * N == [F - (2 if k == 0 else 0)] * N
        v = int(nj)
        assert _agreement(st[:, :v], np.asarray(sj)[:, :v]) >= AGREE
        np.testing.assert_allclose(ft[:, :v].numpy(), np.asarray(fj)[:, :v], atol=CONF_ATOL)
        pcm = pcm * 0.9 + 0.1


def test_pcm_fleet_reset_rearms_the_streams_own_skip():
    """The JAX fleet shares one skip counter that ``reset_stream`` does not
    re-arm; the port keeps one per stream, so a stream restarted mid-fleet
    decodes exactly as a fresh single-stream PCM step would."""
    N, F = 2, 16
    _, tp = _pair(num_states=8, feature_dim=80, chunk_size=F)
    dec = MultiStreamDecoder(tp, N, F)
    step, carry = dec.make_pcm_step()
    rng = np.random.default_rng(5)
    carry, _, _, nv = step(carry, rng.standard_normal((N, F * 160)).astype(np.float32))
    assert nv.tolist() == [F - 2, F - 2]
    carry = dec.reset_stream(carry, 1)
    single, sc = make_pcm_decode_step(tp, chunk_frames=F)
    for _ in range(2):
        pcm = rng.standard_normal((N, F * 160)).astype(np.float32)
        carry, st, cf, nv = step(carry, pcm)
        sc, s1, c1, n1 = single(sc, pcm[1])
        assert int(nv[1]) == int(n1) and int(nv[0]) == F
        v = int(n1)
        np.testing.assert_array_equal(st[1, :v].numpy(), s1[:v].numpy())
        np.testing.assert_allclose(cf[1, :v].numpy(), c1[:v].numpy(), atol=CONF_ATOL)


def test_pcm_decode_step_matches_jax():
    F = 32
    jp, tp = _pair(num_states=12, feature_dim=80, chunk_size=F)
    j_step, cj = jax_frontend.make_pcm_decode_step(jp, chunk_frames=F)
    t_step, ct = make_pcm_decode_step(tp, chunk_frames=F)
    pcm = np.random.default_rng(6).standard_normal(3 * F * 160).astype(np.float32)
    for k in range(3):
        chunk = pcm[k * F * 160:(k + 1) * F * 160]
        cj, sj, fj, nj = j_step(cj, jnp.asarray(chunk))
        ct, st, ft, nt = t_step(ct, chunk)
        assert int(nt) == int(nj)
        v = int(nj)
        assert _agreement(st[:v], np.asarray(sj)[:v]) >= AGREE
        np.testing.assert_allclose(ft[:v].numpy(), np.asarray(fj)[:v], atol=CONF_ATOL)


def test_framing_tables_are_the_jax_tables():
    want = jax_frontend.framing_tables(16000, 512, 400, 160, 40)
    got = framing_tables(16000, 512, 400, 160, 40, device="cpu")
    for key in ("cos", "sin", "window", "mel_t"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert (got["lag"], got["hop"], got["frame_len"]) == (want["lag"], 160, 400)


@pytest.fixture(scope="module")
def pcm():
    return np.random.default_rng(3).standard_normal(16000 * 2).astype(np.float32)


def test_device_frames_match_jax(pcm):
    tj, tt = jax_frontend.framing_tables(), framing_tables(device="cpu")
    lag = tt["lag"]
    tail_j = jnp.zeros((lag * 160 + 1,), jnp.float32)
    tail_t = torch.zeros((lag * 160 + 1,))
    for k in range(2):
        chunk = pcm[k * 160 * 64:(k + 1) * 160 * 64]
        tail_j, fj = jax_frontend.device_frames(tail_j, jnp.asarray(chunk), tj)
        tail_t, ft = device_frames(tail_t, torch.from_numpy(chunk), tt)
        assert ft.shape == (64, 80)
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **FEAT)
    # Leading stream axes frame each stream on its own.
    two = torch.from_numpy(pcm[:2 * 160 * 16].reshape(2, -1).copy())
    tails = torch.zeros((2, lag * 160 + 1))
    _, both = device_frames(tails, two, tt)
    for n in range(2):
        _, one = device_frames(tails[n], two[n], tt)
        torch.testing.assert_close(both[n], one)


def test_device_framer_matches_jax(pcm):
    jf = jax_frontend.DeviceFramer(n_mels=80, chunk_frames=64)
    tf = DeviceFramer(n_mels=80, chunk_frames=64, device="cpu")
    got, want = [], []
    for piece in np.array_split(pcm, 5):
        jf.push(piece)
        tf.push(piece)
        want.append(jf.pop())
        got.append(tf.pop())
        assert got[-1].shape == want[-1].shape
    got, want = np.concatenate(got), np.concatenate(want)
    assert len(got) >= 150 and got.dtype == np.float32 and not tf.is_native
    np.testing.assert_allclose(got, want, **FEAT)
    tf.reset()
    tf.push(pcm[:64 * 160])
    np.testing.assert_array_equal(tf.pop(), got[:62])


def _proc(**kw):
    defaults = dict(num_states=5, feature_dim=8, chunk_size=20, lookahead_frames=5,
                    max_delay_frames=60, use_beam_search=False, beam_width=4, device="cpu")
    defaults.update(kw)
    return StreamingHMMProcessor(**defaults)


def test_buffering_and_every_frame_decoded_once():
    rng = np.random.default_rng(0)
    p = _proc()
    r = p.process_chunk(_feats(rng, (10, 8)))
    assert r.status == "buffering" and r.decoded_states is None and r.metadata["frames_needed"] > 0
    for use_beam in (False, True):
        p = _proc(use_beam_search=use_beam, lookahead_frames=0, max_delay_frames=100,
                  chunk_size=16)
        total = 0
        for _ in range(4):
            r = p.process_chunk(torch.from_numpy(_feats(rng, (16, 8))))
            total += len(r.decoded_states)
            assert 0.0 <= r.confidence <= 1.0 + 1e-6
        assert total == 64


def test_stats_breakdown_optimize_and_reset():
    rng = np.random.default_rng(1)
    p = _proc(use_beam_search=True, beam_width=4)
    assert "message" in p.get_performance_stats()
    for _ in range(4):
        p.process_chunk(_feats(rng, (20, 8)))
    stats = p.get_performance_stats()
    assert stats["total_chunks_processed"] >= 1 and stats["avg_processing_time_ms"] > 0
    assert stats["processing_mode"] == "beam_search" and stats["beam_width"] == 4
    bd = p.get_latency_breakdown()
    assert bd["total"] > 0 and bd["emission_computation"] >= 0 and bd["viterbi_decoding"] >= 0
    p.optimize_for_latency(target_latency_ms=1e-6)
    assert p.beam_width == 3 and p._beam_paths.shape == (3, 65)
    p.optimize_for_latency(target_latency_ms=1e9)
    assert p.use_beam_search and p.beam_width == 4 and p._beam_scores.shape == (4,)
    assert p.process_chunk(_feats(rng, (20, 8))).status == "decoded"
    p.reset_streaming_state()
    assert p.total_frames_processed == 0 and p.last_output_frame == -1 and len(p._buffer) == 0


def test_resize_beam_matches_jax_on_ties():
    """Shrinking keeps the best hypotheses in a stable order, as
    ``jnp.argsort`` does, ties included."""
    jp, tp = _pair(num_states=6, feature_dim=4, chunk_size=8, beam_width=6)
    scores = np.array([-1.0, -0.5, -1.0, -0.5, -2.0, -0.5], np.float32)
    paths = np.arange(6 * 13, dtype=np.int32).reshape(6, 13)
    jp._beam_scores, jp._beam_paths = jnp.asarray(scores), jnp.asarray(paths)
    tp._beam_scores, tp._beam_paths = torch.from_numpy(scores), torch.from_numpy(paths)
    for w in (3, 5):
        jp.beam_width = tp.beam_width = w
        jp._resize_beam()
        tp._resize_beam()
        for a, b in ((tp._beam_scores, jp._beam_scores), (tp._beam_states, jp._beam_states),
                     (tp._beam_paths, jp._beam_paths)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_async_round_trip():
    rng = np.random.default_rng(2)
    p = _proc(chunk_size=8, lookahead_frames=0, use_beam_search=True, beam_width=3)
    p.start_async_processing()
    for _ in range(5):
        assert p.add_audio_chunk_async(_feats(rng, (8, 8)))
    deadline = time.time() + 20.0
    results = []
    while len(results) < 5 and time.time() < deadline:
        r = p.get_result_async()
        if r is not None:
            results.append(r)
        else:
            time.sleep(0.02)
    p.stop_async_processing()
    assert len(results) == 5 and all(r.status == "decoded" for r in results)


@pytest.mark.parametrize("latency,chunk_moves,beam", [(150.0, -1, False), (10.0, 1, True)])
def test_controller_adapts_and_cools_down(latency, chunk_moves, beam):
    ctrl = AdaptiveLatencyController(target_latency_ms=50.0)
    ctrl.last_adjustment_time = -10.0
    recs = [ctrl.update(latency, 200) for _ in range(15)]
    fired = [r for r in recs if r]
    assert len(fired) == 1
    assert (fired[0]["chunk_size"] - 160) * chunk_moves > 0
    assert fired[0]["use_beam_search"] is beam
    assert ctrl.update(latency, 200) == {}


def test_default_device_is_the_card():
    sig = inspect.signature(StreamingHMMProcessor)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(DeviceFramer).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            StreamingHMMProcessor(4, 3)
