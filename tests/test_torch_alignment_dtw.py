"""Every public function of the port's ``alignment/dtw.py`` against its
JAX twin (``pytorch_hmm_tpu/alignment/dtw.py``) on the same numpy inputs.

* ``compute_distance_matrix``: the three metrics within atol 1e-5 + rtol
  1e-5 (products and norms summed in another order; the distances are
  O(1)-O(10)).
* Given the same distance matrix (both packages' ``compute_distance_matrix``
  stood in by one matrix): ``dtw_distance``, ``dtw_alignment``,
  ``compute_dtw_path``, ``dtw_path_padded``, the aligners and
  ``phoneme_audio_alignment`` are bit-identical (adds and compares only).
* End to end from features, the aligners run on integer-valued features:
  their euclidean distances are exact in both packages (integer sums and
  products below 2^24, one correctly rounded sqrt), so the matrices are
  equal bit for bit (asserted) and no path can flip.
* Soft-DTW: values within rtol 1e-5, gradients (through autograd against
  ``jax.value_and_grad``) within atol 1e-5 + rtol 1e-4: float32 logsumexp
  chains of N+M-1 steps in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu.alignment.dtw as jdtw
import pytorch_hmm_tpu_torch.alignment.dtw as tdtw
from pytorch_hmm_tpu_torch import ConstrainedDTWAligner, DTWAligner, alignment

DIST_ATOL, DIST_RTOL = 1e-5, 1e-5
SOFT_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
METRICS = ["euclidean", "cosine", "manhattan"]
PATTERNS = ["symmetric", "asymmetric", "rabiner_juang"]


def features(n, m, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return (rng.integers(-3, 4, size=(n, d)).astype(np.float32),
                rng.integers(-3, 4, size=(m, d)).astype(np.float32))
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(m, d)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def shared_distances(monkeypatch, dist):
    """Both packages' ``compute_distance_matrix`` return ``dist``."""
    monkeypatch.setattr(jdtw, "compute_distance_matrix", lambda x, y, fn="euclidean": jnp.asarray(dist))
    monkeypatch.setattr(tdtw, "compute_distance_matrix", lambda x, y, fn="euclidean": t(dist))


def assert_paths_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_matches(metric):
    x, y = features(23, 31, 13, seed=1)
    want = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y), metric))
    got = tdtw.compute_distance_matrix(t(x), t(y), metric).numpy()
    assert got.shape == (23, 31)
    np.testing.assert_allclose(got, want, atol=DIST_ATOL, rtol=DIST_RTOL)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="Unknown distance function"):
        tdtw.compute_distance_matrix(torch.zeros(2, 3), torch.zeros(2, 3), "hamming")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_hard_dtw_functions_bit_identical_given_the_same_distances(monkeypatch, pattern):
    x, y = features(19, 26, 5, seed=2)
    dist = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y)))
    jd, td = jnp.asarray(dist), t(dist)

    got, want = tdtw.compute_dtw_path(td, pattern), jdtw.compute_dtw_path(jd, pattern)
    assert_paths_equal(got, want)
    got, want = tdtw.dtw_path_padded(td, pattern), jdtw.dtw_path_padded(jd, pattern)
    assert_paths_equal(got[:2], want[:2])
    assert int(got[2]) == int(want[2]) and float(got[3]) == float(want[3])

    shared_distances(monkeypatch, dist)
    assert float(tdtw.dtw_distance(t(x), t(y), step_pattern=pattern)) == \
        float(jdtw.dtw_distance(jnp.asarray(x), jnp.asarray(y), step_pattern=pattern))
    got = tdtw.dtw_alignment(t(x), t(y), step_pattern=pattern)
    want = jdtw.dtw_alignment(jnp.asarray(x), jnp.asarray(y), step_pattern=pattern)
    assert_paths_equal(got[:2], want[:2])
    assert float(got[2]) == float(want[2])
    # The trimmed path runs from the origin to the corner, one step at a time.
    pi, pj = got[0].numpy(), got[1].numpy()
    assert (pi[0], pj[0]) == (0, 0) and (pi[-1], pj[-1]) == (18, 25)
    assert np.all(np.diff(pi) >= 0) and np.all(np.diff(pj) >= 0)
    assert np.all(np.diff(pi) + np.diff(pj) >= 1)


@pytest.mark.parametrize("metric", METRICS)
def test_dtw_distance_from_features(metric):
    """End to end from features: the metric's distances differ by rounding
    only, so the costs agree within the distances' tolerance summed along
    a path of at most N+M-1 cells."""
    x, y = features(17, 12, 6, seed=3)
    want = float(jdtw.dtw_distance(jnp.asarray(x), jnp.asarray(y), metric))
    got = float(tdtw.dtw_distance(t(x), t(y), metric))
    assert got == pytest.approx(want, abs=28 * DIST_ATOL, rel=DIST_RTOL)


def test_soft_dtw_value_and_gradient():
    x, y = features(14, 11, 5, seed=4)
    jval, (jgx, jgy) = jax.value_and_grad(lambda a, b: jdtw.soft_dtw(a, b, 0.1), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    val = tdtw.soft_dtw(tx, ty, 0.1)
    val.backward()
    assert float(val.detach()) == pytest.approx(float(jval), rel=SOFT_RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("gamma", [0.1, 1.0])
def test_soft_dtw_alignment_is_the_reference_occupation_matrix(monkeypatch, gamma):
    x, y = features(12, 15, 4, seed=5)
    dist = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y)))
    shared_distances(monkeypatch, dist)
    jalign, jcost = jdtw.soft_dtw_alignment(jnp.asarray(x), jnp.asarray(y), gamma)
    align, cost = tdtw.soft_dtw_alignment(t(x), t(y), gamma)
    assert float(cost) == pytest.approx(float(jcost), rel=SOFT_RTOL)
    np.testing.assert_allclose(align.numpy(), np.asarray(jalign), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # The corners are always occupied.
    assert align[0, 0] == pytest.approx(1.0, abs=1e-5) and align[-1, -1] == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dtw_aligner_hard_from_integer_features(pattern):
    x, y = features(21, 16, 6, seed=6, integer=True)
    np.testing.assert_array_equal(
        tdtw.compute_distance_matrix(t(x), t(y)).numpy(),
        np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y))))
    got = DTWAligner(step_pattern=pattern, device="cpu")(t(x), t(y))
    want = jdtw.DTWAligner(step_pattern=pattern)(jnp.asarray(x), jnp.asarray(y))
    assert_paths_equal(got[:2], want[:2])
    assert float(got[2]) == float(want[2])


def test_dtw_aligner_batched_returns_lists():
    x = np.stack([features(13, 9, 4, seed=s, integer=True)[0] for s in range(3)])
    y = np.stack([features(13, 9, 4, seed=s, integer=True)[1] for s in range(3)])
    got = DTWAligner(device="cpu")(t(x), t(y))
    want = jdtw.DTWAligner()(jnp.asarray(x), jnp.asarray(y))
    assert isinstance(got[0], list) and len(got[0]) == 3
    for k in range(2):
        assert_paths_equal(got[k], want[k])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_dtw_aligner_soft(monkeypatch):
    """The soft aligner's hard path is each frame's argmax of the expected
    alignment; on these inputs every row's top two entries differ by more
    than 1e-3 (asserted), far above the gradients' tolerance, so no argmax
    can flip."""
    x, y = features(10, 13, 4, seed=7)
    dist = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y)))
    shared_distances(monkeypatch, dist)
    got = DTWAligner(soft_dtw=True, gamma=0.5, device="cpu")(t(x), t(y))
    want = jdtw.DTWAligner(soft_dtw=True, gamma=0.5)(jnp.asarray(x), jnp.asarray(y))
    align, _ = tdtw.soft_dtw_alignment(t(x), t(y), 0.5)
    top2 = torch.topk(align, 2, dim=1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
    assert_paths_equal(got[:2], want[:2])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=SOFT_RTOL)


@pytest.mark.parametrize("bandwidth", [2, 100])
def test_constrained_aligner_band(bandwidth):
    """N=37, M=23 (M does not divide N): the band is computed in float32
    on both sides and agrees cell for cell; the paths stay inside it."""
    x, y = features(37, 23, 5, seed=8, integer=True)
    dist = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y)))
    band = tdtw._bandwidth_mask(t(dist), bandwidth).numpy()
    np.testing.assert_array_equal(band, np.asarray(jdtw._bandwidth_mask(jnp.asarray(dist), bandwidth)))
    assert np.isinf(band).any() == (bandwidth == 2)
    got = ConstrainedDTWAligner(bandwidth=bandwidth, device="cpu")(t(x), t(y))
    want = jdtw.ConstrainedDTWAligner(bandwidth=bandwidth)(jnp.asarray(x), jnp.asarray(y))
    assert_paths_equal(got[:2], want[:2])
    assert float(got[2]) == float(want[2])
    assert np.isfinite(float(got[2]))
    assert np.all(np.isfinite(band[got[0].numpy(), got[1].numpy()]))


def test_constrained_aligner_keeps_its_band_over_kwargs():
    a = ConstrainedDTWAligner(bandwidth=4, step_pattern="rabiner_juang", device="cpu")
    assert a.bandwidth == 4 and a.step_pattern == "rabiner_juang" and a.monotonic
    assert list(a.parameters()) == []


def test_phoneme_audio_alignment_and_durations(monkeypatch):
    rng = np.random.default_rng(9)
    ph = rng.normal(size=(12, 8)).astype(np.float32)
    audio = rng.normal(size=(50, 8)).astype(np.float32)
    dist = np.asarray(jdtw.compute_distance_matrix(jnp.asarray(ph), jnp.asarray(audio), "cosine"))
    shared_distances(monkeypatch, dist)
    got = tdtw.phoneme_audio_alignment(t(ph), t(audio))
    want = jdtw.phoneme_audio_alignment(jnp.asarray(ph), jnp.asarray(audio))
    assert_paths_equal(got, want)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert int(got[1][0]) == 0 and int(got[1][-1]) == 50
    durations = tdtw.extract_phoneme_durations(got[0], 12)
    np.testing.assert_array_equal(durations.numpy(),
                                  np.asarray(jdtw.extract_phoneme_durations(want[0], 12)))
    assert int(durations.sum()) == 50
    # Ids outside [0, num_phonemes) count nowhere, as with the reference's one-hot.
    ids = np.array([0, 3, 3, 7, -1, 2], np.int32)
    np.testing.assert_array_equal(tdtw.extract_phoneme_durations(t(ids), 4).numpy(),
                                  np.asarray(jdtw.extract_phoneme_durations(jnp.asarray(ids), 4)))


def test_exports_match_the_reference():
    import pytorch_hmm_tpu.alignment as jalign

    assert set(tdtw.__all__) == set(jdtw.__all__)
    exported = {n for n in jalign.__all__ if n in jdtw.__all__}
    assert exported and exported <= set(alignment.__all__)
