"""The DTW wavefront and backtrace (row 19 of the JAX package's kernels):
the port's plain version against the JAX package's XLA scan pair
(``_dtw_wavefront`` + ``_backtrace``) and its Pallas kernel in interpret
mode, on the same numpy distance matrices; the wrapper, the envelope and
the dispatch.

Every comparison is exact (``assert_array_equal`` on cost matrices,
choices and paths, ``==`` on lengths and final costs): the recurrence
adds and compares only, both sides break ties diag > up > left, and the
reference's kernel is bit-identical to its scans
(``tests/test_ops_dtw.py``). Cases: the edge shapes 1x1, 1xM, Nx1, shapes
off every tile, a Sakoe-Chiba band of ``+inf`` cells, and an
integer-valued matrix whose equal sums force ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu.alignment.dtw as jdtw
import pytorch_hmm_tpu_torch.alignment.dtw as tdtw
from pytorch_hmm_tpu.ops.dtw import pallas_dtw as jax_pallas_dtw
from pytorch_hmm_tpu.ops.dtw import pallas_dtw_supported as jax_supported
from pytorch_hmm_tpu_torch.ops import dtw as tops

SHAPES = [(1, 1), (1, 7), (7, 1), (5, 9), (16, 16), (37, 23), (64, 128), (130, 40)]
PATTERNS = ["symmetric", "asymmetric", "rabiner_juang"]


def distances(n, m, seed, integer=False):
    """``(n, m)`` float32 distances from a seed: euclidean distances of
    standard normal features (the JAX package's ``compute_distance_matrix``),
    or small integers, whose equal sums force ties."""
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 3, size=(n, m)).astype(np.float32)
    x = rng.normal(size=(n, 7)).astype(np.float32)
    y = rng.normal(size=(m, 7)).astype(np.float32)
    return np.asarray(jdtw.compute_distance_matrix(jnp.asarray(x), jnp.asarray(y)))


def assert_same_scan(dist, pattern):
    """The port's plain wavefront and backtrace equal the JAX scans."""
    cost, choices = jdtw._dtw_wavefront(jnp.asarray(dist), pattern)
    pi, pj, length = jdtw._backtrace(choices)
    tcost, tchoices = tops.dtw_wavefront(torch.from_numpy(dist.copy()), pattern)
    tpi, tpj, tlength = tops.dtw_backtrace(tchoices)
    np.testing.assert_array_equal(tcost.numpy(), np.asarray(cost))
    np.testing.assert_array_equal(tchoices.numpy(), np.asarray(choices))
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(tpj.numpy(), np.asarray(pj))
    assert int(tlength) == int(length)
    return tcost, (tpi, tpj, tlength)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_scan_is_the_reference_scan(n, m, pattern):
    assert_same_scan(distances(n, m, n * 1000 + m), pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_scan_on_a_band_of_inf(pattern):
    """Cells off a Sakoe-Chiba band are +inf; the band of the reference
    and of the port agree cell for cell, and so do the scans over it."""
    dist = distances(40, 33, 3)
    band = np.asarray(jdtw._bandwidth_mask(jnp.asarray(dist), 6))
    tband = tdtw._bandwidth_mask(torch.from_numpy(dist.copy()), 6).numpy()
    np.testing.assert_array_equal(tband, band)
    assert np.isinf(band).any()
    assert_same_scan(band, pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,m", [(16, 16), (37, 23)])
def test_plain_scan_breaks_ties_as_the_reference(n, m, pattern):
    dist = distances(n, m, 7, integer=True)
    _, choices = jdtw._dtw_wavefront(jnp.asarray(dist), pattern)
    assert_same_scan(dist, pattern)
    # Ties were forced: some choices are not the diagonal.
    assert np.asarray(choices).any()


@pytest.mark.parametrize("n,m,pattern", [(16, 16, "symmetric"), (37, 23, "rabiner_juang")])
def test_plain_version_is_the_reference_kernel(n, m, pattern):
    """The JAX Pallas kernel in interpret mode and the port's plain
    version (which its CUDA kernel is held to on the card)."""
    dist = distances(n, m, 11)
    kpi, kpj, klen, kcost = jax_pallas_dtw(jnp.asarray(dist), pattern)
    pi, pj, length, cost = tops.pallas_dtw_reference(torch.from_numpy(dist.copy()), pattern)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(kpi))
    np.testing.assert_array_equal(pj.numpy(), np.asarray(kpj))
    assert int(length) == int(klen)
    assert float(cost) == float(kcost)


def test_wrapper_on_cpu_runs_the_plain_version():
    dist = torch.from_numpy(distances(9, 14, 5))
    before = tops.pallas_dtw.launches
    got = tops.pallas_dtw(dist, "rabiner_juang")
    want = tops.pallas_dtw_reference(dist, "rabiner_juang")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    assert tops.pallas_dtw.launches == before
    # The path convention: N+M-1 entries, origin first, ending at (N-1, M-1).
    pi, pj, length, _ = got
    assert pi.shape == (22,) and (int(pi[-1]), int(pj[-1])) == (8, 13)
    assert int(pi[0]) == int(pj[0]) == 0
    assert torch.all(pi[: 22 - int(length)] == 0) and torch.all(pj[: 22 - int(length)] == 0)


def test_envelope_takes_every_shape_the_reference_takes():
    assert tops.pallas_dtw_supported(500, 500)
    assert tops.pallas_dtw_supported(4000, 4000)   # the reference's VMEM refuses it
    assert not tops.pallas_dtw_supported(4097, 10)
    assert not tops.pallas_dtw_supported(0, 10)
    for n in (1, 7, 128, 129, 500, 700, 1024, 1100):
        for m in (1, 40, 500, 2000, 5000, 5200):
            if jax_supported(n, m):
                assert tops.pallas_dtw_supported(n, m), (n, m)


def test_unknown_pattern_raises():
    with pytest.raises(ValueError, match="step pattern"):
        tops.pallas_dtw(torch.zeros(3, 3), "itakura")


@pytest.mark.parametrize("fn", ["dtw_path_padded", "dtw_distance"])
def test_dispatch_sends_off_cpu_tensors_to_the_kernel(monkeypatch, fn):
    """Tensors off the CPU (meta stands in for CUDA) inside the envelope
    reach ``pallas_dtw`` and never the plain wavefront; the wrapper then
    refuses the meta device (no fallback)."""
    calls = []

    def plain(*args, **kwargs):
        raise AssertionError("the plain wavefront ran")

    monkeypatch.setattr(tdtw, "_dtw_wavefront", plain)
    monkeypatch.setattr(tdtw, "pallas_dtw", lambda d, p: calls.append((tuple(d.shape), p)) or
                        (None, None, None, "cost"))
    if fn == "dtw_path_padded":
        out = tdtw.dtw_path_padded(torch.empty(500, 500, device="meta"), "rabiner_juang")
        assert out[3] == "cost"
    else:
        x, y = torch.empty(300, 80, device="meta"), torch.empty(200, 80, device="meta")
        assert tdtw.dtw_distance(x, y, step_pattern="rabiner_juang") == "cost"
    assert calls == [((500, 500) if fn == "dtw_path_padded" else (300, 200), "rabiner_juang")]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tdtw.dtw_path_padded(torch.empty(500, 500, device="meta"))


class _Plain(Exception):
    pass


def test_dispatch_outside_the_envelope_and_on_cpu_runs_the_plain_wavefront(monkeypatch):
    """Past the envelope (meta stands in for CUDA), on the CPU, and for
    ``compute_dtw_path`` (which returns the whole cost matrix) on any
    device, the plain wavefront runs and the kernel never does."""
    seen = []

    def kernel(*args):
        raise AssertionError("the kernel was called")

    def plain(d, p):
        seen.append((d.device.type, tuple(d.shape)))
        raise _Plain

    monkeypatch.setattr(tdtw, "pallas_dtw", kernel)
    monkeypatch.setattr(tdtw, "_dtw_wavefront", plain)
    x = torch.from_numpy(np.ones((6, 3), np.float32))
    for call in (lambda: tdtw.dtw_path_padded(torch.empty(4097, 1, device="meta")),
                 lambda: tdtw.dtw_path_padded(torch.ones(6, 4)),
                 lambda: tdtw.dtw_distance(x, x[:4]),
                 lambda: tdtw.compute_dtw_path(torch.empty(500, 500, device="meta"))):
        with pytest.raises(_Plain):
            call()
    assert seen == [("meta", (4097, 1)), ("cpu", (6, 4)), ("cpu", (6, 4)), ("meta", (500, 500))]
