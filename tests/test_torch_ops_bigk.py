"""Large-state scoring (row 15 of the JAX package's kernels,
``bigk_log_likelihood``): the port's plain version against the JAX
Pallas kernel in interpret mode and against the reference's
``core.log_likelihood``, on the same numpy inputs; the off-grid route,
the rescale schedule, the envelope and the dispatch.

Tolerances:
* plain version vs the JAX kernel: atol 1e-3 + rtol 1e-5. Both round
  ``q`` to bf16 each frame and sum the products in float32 (JAX streams
  float32 log-obs at these shapes); a sum taken in another order can move
  a bf16 rounding of ``q`` by one unit, ~2e-3 of one state's mass, which
  the chain then carries. On the CPU the two agree to the bit.
* both vs ``core.log_likelihood`` (float32 log-space): atol 0.05, rtol
  1e-3, the JAX kernel test's scoring tolerance (tests/test_ops_bigk.py).
* the off-grid route (``pallas_forward``'s log Z): atol 1e-3, that test's
  own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.core import log_likelihood as jax_core_ll
from pytorch_hmm_tpu.ops.bigk import bigk_log_likelihood as jax_bigk
from pytorch_hmm_tpu.ops.bigk import bigk_supported as jax_bigk_supported
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops import bigk as tbigk

KERNEL_ATOL, KERNEL_RTOL = 1e-3, 1e-5
SCORE_ATOL, SCORE_RTOL = 0.05, 1e-3


def problem(B, T, K, seed, uniform_prior=False):
    """``(log_obs, log_a, log_pi)`` float32 numpy: standard normal
    log-obs, dense ``log_softmax`` transitions and prior."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.normal(size=(K, K)), jnp.float32), axis=-1))
    if uniform_prior:
        lpi = np.full((K,), -np.log(float(K)), np.float32)
    else:
        lpi = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.normal(size=(K,)), jnp.float32)))
    return lo, la, lpi


def both(args):
    return [jnp.asarray(a) for a in args], [torch.from_numpy(a.copy()) for a in args]


# (B, T, K, t_chunk): B and K off the kernel's tiles (16 rows, 64 states)
# in every case but one; t_chunk=32 moves the rescale schedule.
CASES = {
    "4x256x96": (4, 256, 96, 128),
    "2x128x256": (2, 128, 256, 128),
    "3x256x40": (3, 256, 40, 128),
    "17x128x65": (17, 128, 65, 128),
    "5x96x33 t_chunk=32": (5, 96, 33, 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_reference_kernel_and_core(case):
    B, T, K, tc = CASES[case]
    jargs, targs = both(problem(B, T, K, seed=B * T + K))
    want = np.asarray(jax_bigk(*jargs, t_chunk=tc))
    got = tbigk.bigk_log_likelihood_reference(*targs, t_chunk=tc).numpy()
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    exact = np.asarray(jax_core_ll(*jargs))
    np.testing.assert_allclose(got, exact, atol=SCORE_ATOL, rtol=SCORE_RTOL)
    np.testing.assert_allclose(want, exact, atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_wrapper_on_cpu_runs_the_plain_version():
    _, targs = both(problem(3, 256, 40, seed=1))
    before = ops.bigk_log_likelihood.launches
    got = ops.bigk_log_likelihood(*targs)
    assert torch.equal(got, ops.bigk_log_likelihood_reference(*targs))
    assert got.shape == (3,) and got.dtype == torch.float32
    assert ops.bigk_log_likelihood.launches == before


def test_off_grid_T_takes_pallas_forward_log_z():
    """T=200 is not a multiple of t_chunk=128: both packages take their
    ``pallas_forward``'s log Z (a padded frame would be a real step)."""
    jargs, targs = both(problem(4, 200, 256, seed=5, uniform_prior=True))
    got = ops.bigk_log_likelihood(*targs).numpy()
    np.testing.assert_allclose(got, ops.pallas_forward(*targs)[1].numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_bigk(*jargs)), atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jax_core_ll(*jargs)), atol=1e-3)


def test_rescale_schedule_is_the_reference_kernels():
    """After every 16 frames of a chunk and at its end; chunk 0 starts at
    frame 1 (frame 0 is the prior), so at t_chunk=128 its blocks end at
    16, 32, ..., 112 and 127, and chunk 1's at 143, ..., 255."""
    got = [t for t in range(1, 384) if tbigk.rescales_after(t, 128)]
    want = [16 * i for i in range(1, 8)] + [127] + \
        [c * 128 + 16 * i - 1 for c in (1, 2) for i in range(1, 9)]
    assert got == want
    assert [t for t in range(1, 6) if tbigk.rescales_after(t, 1)] == [1, 2, 3, 4, 5]
    assert [t for t in range(1, 40) if tbigk.rescales_after(t, 20)] == [16, 19, 35, 39]


def test_envelope_takes_every_shape_the_reference_takes():
    for K in (1, 12, 33, 64, 96, 128, 200, 256, 384, 512, 640, 1000, 1024):
        for B in (1, 7, 8, 16, 17, 24, 48, 64, 96, 200, 216, 256):
            if jax_bigk_supported(K, B):
                assert ops.bigk_supported(K, B), (K, B)
    assert ops.bigk_supported(512, 48) and ops.bigk_supported(1024, 16)
    assert not ops.bigk_supported(1025, 8)
    assert not ops.bigk_supported(64, tbigk.MAX_BIGK_BATCH + 1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_outside_the_envelope_raises_on_every_device(device):
    lo = torch.zeros(2, 128, 1025, device=device)
    la, lp = torch.zeros(1025, 1025, device=device), torch.zeros(1025, device=device)
    with pytest.raises(ValueError, match="unsupported"):
        ops.bigk_log_likelihood(lo, la, lp)


def test_dispatch_sends_off_cpu_tensors_to_the_kernel_or_pallas_forward(monkeypatch):
    """Meta tensors stand in for CUDA ones: on the chunk grid they reach
    the launch, which refuses the meta device (no fallback); off it they
    reach ``pallas_forward``."""
    lo, la, lp = (torch.empty(16, 256, 512, device="meta"), torch.empty(512, 512, device="meta"),
                  torch.empty(512, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.bigk_log_likelihood(lo, la, lp)
    calls = []
    monkeypatch.setattr(tbigk, "pallas_forward",
                        lambda *a: calls.append(tuple(a[0].shape)) or (None, "log z"))
    assert ops.bigk_log_likelihood(lo[:, :200], la, lp) == "log z"
    assert calls == [(16, 200, 512)]


def test_fragment_layout_holds_each_mma_b_fragment():
    """Lane l of n-tile nt, k-tile kt holds P[16 kt + 2 (l % 4) + {0, 1,
    8, 9}, 8 nt + l // 4]: the m16n8k16 B fragment."""
    kp = 64
    pa = torch.arange(kp * kp, dtype=torch.float32).reshape(kp, kp)
    frags = tbigk._fragments(pa)
    assert frags.shape == (kp // 16, kp // 8, 32, 4)
    for kt, nt, lane in [(0, 0, 0), (1, 3, 5), (3, 7, 31), (2, 5, 18)]:
        k = 16 * kt + 2 * (lane % 4)
        n = 8 * nt + lane // 4
        assert frags[kt, nt, lane].tolist() == [pa[k, n], pa[k + 1, n], pa[k + 8, n], pa[k + 9, n]]
    assert tbigk.padded_states(1) == 64 and tbigk.padded_states(65) == 128
    assert tbigk.padded_states(1024) == 1024


def _reassemble(slices: torch.Tensor) -> torch.Tensor:
    """Inverse of ``cluster_fragments``: P from its CTA slices."""
    cs, kt, ntc = slices.shape[:3]
    kp = kt * 16
    pa = torch.empty((kp, kp), dtype=slices.dtype)
    lane = torch.arange(32)
    for c in range(cs):
        for t in range(kt):
            for n in range(ntc):
                cols = (c * ntc + n) * 8 + lane // 4
                for e in range(4):
                    rows = t * 16 + 2 * (lane % 4) + (e % 2) + 8 * (e // 2)
                    pa[rows, cols] = slices[c, t, n, :, e]
    return pa


@pytest.mark.parametrize("kp,cs", [(kp, cs) for kp in (64, 256, 512, 1024)
                                   for cs in (1, 2, 4, 8, 16) if kp % (8 * cs) == 0])
def test_cluster_slices_reassemble_p_exactly(kp, cs):
    """Each CTA's slice holds its ``Kp / cs`` columns, all rows, in the
    B-fragment order of ``_fragments``, and the slices give P back bit for
    bit."""
    pa = torch.randn(kp, kp, generator=torch.Generator().manual_seed(kp + cs)).to(torch.bfloat16)
    slices = tbigk.cluster_fragments(pa, cs)
    assert slices.shape == (cs, kp // 16, kp // (8 * cs), 32, 4) and slices.is_contiguous()
    assert torch.equal(_reassemble(slices), pa)
    width = kp // cs
    whole = tbigk._fragments(pa)
    for c in range(cs):
        assert torch.equal(slices[c], whole[:, c * width // 8:(c + 1) * width // 8])


@pytest.mark.parametrize("batch", [1, 16, 48, 4096])
def test_cluster_plan_fits_shared_memory_at_every_k(batch):
    """Every K in 1..1024: CS CTAs whose slices (of a width the kernel
    has) cover Kp, at most 16 of them, ceil(B / 16) clusters, and at most
    232,448 bytes of shared memory a CTA, all of P's slice resident."""
    for k in range(1, tbigk.MAX_BIGK_STATES + 1):
        plan = tbigk.cluster_plan(k, batch)
        assert plan.kp == tbigk.padded_states(k) and plan.kp >= k
        nc = plan.kp // plan.cs
        assert plan.cs * nc == plan.kp and nc in tbigk.SLICE_WIDTHS and 1 <= plan.cs <= 16
        assert plan.rows == 16 and plan.clusters == -(-batch // 16)
        assert plan.kp * nc * 2 < plan.smem <= tbigk.SMEM_LIMIT, (k, plan)
    assert tbigk.cluster_plan(1000, 17) == tbigk.cluster_plan(1024, 32)


@pytest.mark.parametrize("k,batch,cs", [
    (1024, 16, 16), (1024, 4096, 16), (512, 48, 8), (512, 256, 8), (512, 272, 4), (512, 4096, 4),
    (256, 8, 4), (256, 528, 4), (256, 544, 1), (256, 4096, 1), (128, 8, 2), (128, 4096, 1),
    (384, 400, 2), (12, 4, 1), (768, 20, 12), (768, 4096, 12)])
def test_cluster_size_spreads_small_batches_and_packs_large_ones(k, batch, cs):
    """One CTA per 64 columns while every cluster fits on the card's 132
    SMs at once; past that the fewest CTAs whose slice fits."""
    assert tbigk.cluster_plan(k, batch).cs == cs


def test_cluster_plan_bytes_and_refused_slices():
    """The plan's bytes at K=1024 over 16 CTAs: P's slice 131,072, two q
    buffers 66,048, the k partials 18,432 and the row maxima 3,072; a
    cluster size whose slice the kernel has no width for, or whose slice
    does not fit, is refused."""
    assert tbigk.cluster_plan(1024, 16, 16).smem == 131072 + 66048 + 18432 + 3072
    assert tbigk.cluster_plan(256, 8, 1).smem == 256 * 256 * 2 + 2 * 16 * 264 * 2 + 4 * 16 * 264 * 4 + 3 * 4 * 64
    for k, cs in [(512, 3), (512, 1), (64, 2)]:
        with pytest.raises(ValueError, match="no slice"):
            tbigk.cluster_plan(k, 16, cs)
    with pytest.raises(ValueError, match="over 232448"):
        tbigk.cluster_plan(1024, 16, 8)


@pytest.mark.parametrize("kp,cs", [(64, 1), (512, 8), (1024, 16)])
def test_cached_slice_index_gathers_the_cluster_layout(kp, cs):
    """The wrapper's one-gather layout (a cached flat index into P) is
    ``cluster_fragments`` bit for bit."""
    pa = torch.randn(kp, kp, generator=torch.Generator().manual_seed(kp)).to(torch.bfloat16)
    idx = tbigk._slice_index(kp, cs, torch.device("cpu"))
    got = pa.reshape(-1)[idx].reshape(cs, kp // 16, kp // (8 * cs), 32, 4)
    assert torch.equal(got, tbigk.cluster_fragments(pa, cs))


def test_offset_view_of_log_obs_scores_as_its_copy():
    """Log-obs in a contiguous view 4 bytes past its storage's start (on
    the card, off the kernel's 16-byte loads) score as their copy."""
    g = torch.Generator().manual_seed(7)
    b, t, k = 3, 128, 64
    buf = torch.randn(1 + b * t * k, generator=g)
    view = buf[1:].view(b, t, k)
    assert view.is_contiguous() and view.storage_offset() == 1
    la = torch.log_softmax(torch.randn(k, k, generator=g), -1)
    lp = torch.full((k,), -float(np.log(k)))
    torch.testing.assert_close(tbigk.bigk_log_likelihood(view, la, lp),
                               tbigk.bigk_log_likelihood(view.clone(), la, lp), rtol=0, atol=0)
