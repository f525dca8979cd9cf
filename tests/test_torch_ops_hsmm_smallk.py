"""The ``hsmm_smallk`` kernels' plain versions vs the JAX Pallas kernels
in interpret mode.

* D = 1 (``hsmm_smallk_forward`` / ``backward`` on the HMM recursions),
  with a non-zero ``log_dur[:, 0]`` and ragged lengths: atol 2e-4, the
  JAX kernel tests' tolerance (``tests/test_ops_fbsum.py``).
* General D, all four kernels (forward, backward, fb, Viterbi), with
  and without lengths, T < D, ``min_duration`` > 1, S = 1 and S = 32:
  the sum tables within atol 5e-4, the JAX kernel tests' own
  (``tests/test_ops_hsmm.py``); Viterbi paths identical and scores
  equal.

Tables are compared on valid frames only when ragged. The CUDA kernels
are checked against the same plain versions on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_backward as jax_backward
from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_fb as jax_fb
from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_forward as jax_forward
from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_viterbi as jax_viterbi
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops.hsmm_smallk import (
    MAX_DURATION,
    hsmm_smallk_backward,
    hsmm_smallk_backward_general,
    hsmm_smallk_backward_reference,
    hsmm_smallk_fb,
    hsmm_smallk_fb_reference,
    hsmm_smallk_forward,
    hsmm_smallk_forward_general,
    hsmm_smallk_forward_reference,
    hsmm_smallk_supported,
    hsmm_smallk_viterbi,
    hsmm_smallk_viterbi_reference,
)

ATOL = 2e-4


def _problem(B, T, S, seed, dur_scale=0.5):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, S)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    ld = (dur_scale * rng.normal(size=(S, 1))).astype(np.float32)
    return lo, la, lp, ld


CASES = [(3, 130, 5, None), (2, 200, 12, None), (4, 64, 32, None), (2, 1, 4, None),
         (5, 150, 9, (150, 31, 1, 129, 2))]


def _frames(lengths, B, T):
    return lengths or [T] * B


@pytest.mark.parametrize("B,T,S,lens", CASES)
def test_forward_reference_matches_jax_kernel(B, T, S, lens):
    lo, la, lp, ld = _problem(B, T, S, seed=B + T + S)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    a_j, z_j = jax_forward(*(jnp.asarray(x) for x in (lo, la, lp, ld)), jl)
    a_t, z_t = hsmm_smallk_forward_reference(*(torch.from_numpy(x) for x in (lo, la, lp, ld)), tl)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=ATOL)
    for b, n in enumerate(_frames(lens, B, T)):
        np.testing.assert_allclose(a_t[b, :n].numpy(), np.asarray(a_j)[b, :n], atol=ATOL)


@pytest.mark.parametrize("B,T,S,lens", CASES)
def test_backward_reference_matches_jax_kernel(B, T, S, lens):
    lo, la, lp, ld = _problem(B, T, S, seed=B * T + S)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    bs_j, bt_j = jax_backward(*(jnp.asarray(x) for x in (lo, la, ld)), jl)
    bs_t, bt_t = hsmm_smallk_backward_reference(*(torch.from_numpy(x) for x in (lo, la, ld)), tl)
    for b, n in enumerate(_frames(lens, B, T)):
        np.testing.assert_allclose(bs_t[b, :n].numpy(), np.asarray(bs_j)[b, :n], atol=ATOL)
        np.testing.assert_allclose(bt_t[b, :n].numpy(), np.asarray(bt_j)[b, :n], atol=ATOL)
        # At D = 1, beta_start = log_obs + log_dur[:, 0] + beta*, in both
        # packages (the cheap consistency check chip_smoke.py runs on
        # the kernel's own outputs).
        np.testing.assert_allclose(np.asarray(bt_j)[b, :n],
                                   lo[b, :n] + ld[:, 0] + np.asarray(bs_j)[b, :n], atol=ATOL)
        assert torch.all(bs_t[b, n - 1] == 0)


def test_unit_durations_are_the_hmm_recursions():
    """log_dur = 0 gives core's forward and backward exactly."""
    from pytorch_hmm_tpu_torch import core

    lo, la, lp, _ = (torch.from_numpy(x) for x in _problem(2, 40, 6, seed=4))
    zeros = torch.zeros(6, 1)
    a, z = hsmm_smallk_forward(lo, la, lp, zeros)
    a0, z0 = core.forward_log(lo, la, lp)
    assert torch.equal(a, a0) and torch.equal(z, z0)
    assert torch.equal(hsmm_smallk_backward(lo, la, zeros)[0], core.backward_log(lo, la))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_duration_above_one_routes_to_the_general_kernels(device):
    """D > 1 goes to the general-D wrappers: on the CPU their plain
    versions (``core.hsmm``), elsewhere the CUDA kernels, which refuse a
    device that is not CUDA before any work."""
    shapes = ((2, 10, 4), (4, 4), (4,), (4, 3))
    if device == "meta":
        lo, la, lp, ld = (torch.zeros(s, device=device) for s in shapes)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            hsmm_smallk_forward(lo, la, lp, ld)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            hsmm_smallk_backward(lo, la, ld)
        return
    lo, la, lp, ld = (torch.from_numpy(x) for x in _segment_problem(2, 10, 4, 3, seed=3))
    from pytorch_hmm_tpu_torch import core

    for g, w in zip(hsmm_smallk_forward(lo, la, lp, ld), core.hsmm_forward(lo, la, lp, ld)):
        assert torch.equal(g, w)
    for g, w in zip(hsmm_smallk_backward(lo, la, ld), core.hsmm_backward(lo, la, ld)):
        assert torch.equal(g, w)


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    lo, la, lp, ld = (torch.from_numpy(x) for x in _problem(3, 30, 7, seed=9))
    ln = torch.tensor([30, 4, 1], dtype=torch.int32)
    before = hsmm_smallk_forward.launches, hsmm_smallk_backward.launches
    for g, w in zip(hsmm_smallk_forward(lo, la, lp, ld, ln),
                    hsmm_smallk_forward_reference(lo, la, lp, ld, ln)):
        assert torch.equal(g, w)
    for g, w in zip(hsmm_smallk_backward(lo, la, ld, ln),
                    hsmm_smallk_backward_reference(lo, la, ld, ln)):
        assert torch.equal(g, w)
    assert (hsmm_smallk_forward.launches, hsmm_smallk_backward.launches) == before


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    lo, la, lp, ld = (torch.empty(s, device="meta") for s in ((2, 10, 4), (4, 4), (4,), (4, 1)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hsmm_smallk_forward(lo, la, lp, ld)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hsmm_smallk_backward(lo, la, ld)
    with pytest.raises(ValueError, match="K <= 32"):
        hsmm_smallk_backward(torch.empty(2, 10, 33, device="meta"),
                             torch.empty(33, 33, device="meta"), torch.empty(33, 1, device="meta"))


def test_hsmm_smallk_supported_bounds():
    """The card's own limits: S <= 32, D <= 256 (the shared-memory rings),
    any batch; the TPU's B <= 256 and VMEM budget do not carry over."""
    assert hsmm_smallk_supported(1, 1, 1) and hsmm_smallk_supported(32, 1, 4096)
    assert hsmm_smallk_supported(10, 20, 32) and hsmm_smallk_supported(12, 128, 10_000)
    assert hsmm_smallk_supported(32, MAX_DURATION, 1) and MAX_DURATION >= 128
    assert not hsmm_smallk_supported(33, 1, 1)
    assert not hsmm_smallk_supported(12, MAX_DURATION + 1, 32)
    assert not hsmm_smallk_supported(12, 0, 32)


def test_auto_forward_freezes_alpha_past_each_rows_end():
    """``auto_forward`` keeps JAX's frozen-alpha convention; on CPU it is
    ``core.forward_log``, which freezes in the scan."""
    from pytorch_hmm_tpu import ops as jops

    lo, la, lp, _ = _problem(3, 40, 5, seed=12)
    lens = [40, 13, 1]
    a_j, z_j = jops.auto_forward(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp),
                                 jnp.asarray(lens, jnp.int32))
    a_t, z_t = ops.auto_forward(*(torch.from_numpy(x) for x in (lo, la, lp)), torch.tensor(lens))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=ATOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=ATOL)
    for b, n in enumerate(lens):
        assert torch.all(a_t[b, n:] == a_t[b, n - 1])


def test_freeze_fill_gives_the_frozen_scan():
    """The plain-torch fill ``auto_forward`` applies after the kernel
    (whose alpha runs on past each row's end) gives core's frozen alpha."""
    from pytorch_hmm_tpu_torch import core

    lo, la, lp, _ = (torch.from_numpy(x) for x in _problem(3, 40, 5, seed=13))
    lens = torch.tensor([40, 13, 1], dtype=torch.int32)
    running, _ = core.forward_log(lo, la, lp)
    frozen, _ = core.forward_log(lo, la, lp, lens)
    assert torch.equal(ops._freeze_past_end(running, lens), frozen)


# -- general D: the four segment-DP kernels ---------------------------------------

SEG_ATOL = 5e-4


def _segment_problem(B, T, S, D, seed, min_duration=1):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(B, T, S)).astype(np.float32)
    a = rng.dirichlet(np.ones(S), size=S)
    np.fill_diagonal(a, 0.0)
    a = a / np.maximum(a.sum(axis=1, keepdims=True), 1e-30)
    la = np.log(a + 1e-12).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    ld = np.log(rng.dirichlet(np.ones(D), size=S) + 1e-12)
    if min_duration > 1:
        ld[:, : min_duration - 1] = -np.inf
    return lo, la, lp, ld.astype(np.float32)


SEG_CASES = {
    "basic": ((3, 40, 5, 7), {}, None),
    "ragged": ((4, 36, 6, 9), {}, [36, 20, 2, 1]),
    "T<D": ((2, 9, 3, 20), {}, None),
    "min_duration=3": ((3, 30, 5, 8), {"min_duration": 3}, [30, 11, 4]),
    "S=1": ((2, 8, 1, 10), {}, None),
    "S=32": ((2, 24, 32, 6), {}, None),
}


def _seg_case(name):
    shape, kw, lens = SEG_CASES[name]
    arrays = _segment_problem(*shape, seed=sum(shape), **kw)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return arrays, lens, jl, tl


def _close_on_valid(got, want, lens):
    want = np.asarray(want)
    for b, n in enumerate(_frames(lens, got.shape[0], got.shape[1])):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n], atol=SEG_ATOL)


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_general_forward_and_backward_match_jax_kernels(case):
    (lo, la, lp, ld), lens, jl, tl = _seg_case(case)
    a_j, z_j = jax_forward(*(jnp.asarray(x) for x in (lo, la, lp, ld)), jl)
    a_t, z_t = hsmm_smallk_forward_general(*(torch.from_numpy(x) for x in (lo, la, lp, ld)), tl)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=SEG_ATOL)
    _close_on_valid(a_t, a_j, lens)
    bs_j, bt_j = jax_backward(*(jnp.asarray(x) for x in (lo, la, ld)), jl)
    bs_t, bt_t = hsmm_smallk_backward_general(*(torch.from_numpy(x) for x in (lo, la, ld)), tl)
    _close_on_valid(bs_t, bs_j, lens)
    _close_on_valid(bt_t, bt_j, lens)


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_fb_matches_jax_kernels(case):
    """Unragged against the JAX fused kernel; ragged (which the JAX fb
    does not take) against the JAX forward and backward kernels."""
    (lo, la, lp, ld), lens, jl, tl = _seg_case(case)
    got = hsmm_smallk_fb(*(torch.from_numpy(x) for x in (lo, la, lp, ld)), tl)
    if lens is None:
        want = jax_fb(*(jnp.asarray(x) for x in (lo, la, lp, ld)))
    else:
        want = (*jax_forward(*(jnp.asarray(x) for x in (lo, la, lp, ld)), jl),
                *jax_backward(*(jnp.asarray(x) for x in (lo, la, ld)), jl))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=SEG_ATOL)
    for i in (0, 2, 3):
        _close_on_valid(got[i], want[i], lens)


@pytest.mark.parametrize("case", sorted(SEG_CASES) + ["ties", "ties ragged"])
def test_viterbi_matches_jax_kernel(case):
    if case.startswith("ties"):
        # Uniform emissions, transitions and durations: equal durations
        # and equal predecessors everywhere.
        B, T, S, D = 3, 40, 4, 6
        a = np.full((S, S), 1.0 / (S - 1))
        np.fill_diagonal(a, 1e-30)
        arrays = (np.zeros((B, T, S), np.float32), np.log(a).astype(np.float32),
                  np.full(S, -np.log(S), np.float32), np.full((S, D), -np.log(D), np.float32))
        lens = None if case == "ties" else [40, 13, 1]
        jl = None if lens is None else jnp.asarray(lens, jnp.int32)
        tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    else:
        arrays, lens, jl, tl = _seg_case(case)
    s_j, c_j = jax_viterbi(*(jnp.asarray(x) for x in arrays), jl)
    s_t, c_t = hsmm_smallk_viterbi(*(torch.from_numpy(x) for x in arrays), tl)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_general_wrappers_on_cpu_run_plain_versions_without_launching():
    lo, la, lp, ld = (torch.from_numpy(x) for x in _segment_problem(3, 20, 5, 6, seed=2))
    ln = torch.tensor([20, 7, 1], dtype=torch.int32)
    fns = (hsmm_smallk_forward_general, hsmm_smallk_backward_general, hsmm_smallk_fb,
           hsmm_smallk_viterbi)
    before = [f.launches for f in fns]
    pairs = [
        (hsmm_smallk_fb(lo, la, lp, ld, ln), hsmm_smallk_fb_reference(lo, la, lp, ld, ln)),
        (hsmm_smallk_viterbi(lo, la, lp, ld, ln), hsmm_smallk_viterbi_reference(lo, la, lp, ld, ln)),
        (hsmm_smallk_forward(lo, la, lp, ld, ln), hsmm_smallk_forward_reference(lo, la, lp, ld, ln)),
        (hsmm_smallk_backward(lo, la, ld, ln), hsmm_smallk_backward_reference(lo, la, ld, ln)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [f.launches for f in fns] == before


def test_general_wrappers_refuse_what_the_kernels_do_not_take():
    lo, la, lp = (torch.empty(s, device="meta") for s in ((2, 10, 4), (4, 4), (4,)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hsmm_smallk_viterbi(lo, la, lp, torch.empty(4, 5, device="meta"))
    with pytest.raises(ValueError, match="D <= 256"):
        hsmm_smallk_fb(lo, la, lp, torch.empty(4, MAX_DURATION + 1, device="meta"))
    with pytest.raises(ValueError, match="K <= 32"):
        hsmm_smallk_viterbi(torch.empty(2, 10, 33, device="meta"), torch.empty(33, 33, device="meta"),
                            torch.empty(33, device="meta"), torch.empty(33, 5, device="meta"))


# -- hsmm_smallk_fb's lane split -----------------------------------------------


@pytest.mark.parametrize("S", [1, 5, 9, 10, 16, 17, 31, 32])
def test_fb_plan_covers_every_window(S):
    """Every D takes a power-of-two split of at most 16 lanes a state whose
    slices of 8 (or 16) terms cover the D - 1 older terms, in one block
    of at most 1024 threads and within a block's shared memory; the ring
    stride keeps a state's lanes and the warp's states in distinct banks."""
    from pytorch_hmm_tpu_torch.ops import hsmm_smallk

    for D in range(1, hsmm_smallk.MAX_DURATION + 1):
        plan = hsmm_smallk.fb_plan(S, D)
        g = plan.lanes
        assert g & (g - 1) == 0 and 1 <= g <= 16
        assert plan.terms in (8, 16) and g * plan.terms >= D - 1
        assert plan.terms == 8 or g == 16
        assert g == 1 or -(-(D - 1) // (g // 2)) > 8          # the fewest lanes that do
        assert plan.threads == 32 * (1 + -(-S * g // 32)) <= 1024
        assert plan.stride >= D and plan.stride % 32 == g % 32
        assert plan.smem == 4 * (2 * S * plan.stride + 2 * 64 * S + 6 * 32) <= 232448


@pytest.mark.parametrize("S,D,lanes,terms,threads", [
    (10, 20, 4, 8, 96),      # the bench's HSMMLayer: 5 terms a lane
    (10, 128, 16, 8, 192),
    (32, 20, 4, 8, 160),
    (9, 15, 2, 8, 64),
    (32, 256, 16, 16, 544),
    (10, 1, 1, 8, 64),       # D = 1: no older terms
    (10, 9, 1, 8, 64),
])
def test_fb_plan_values(S, D, lanes, terms, threads):
    from pytorch_hmm_tpu_torch.ops import hsmm_smallk

    plan = hsmm_smallk.fb_plan(S, D)
    assert (plan.lanes, plan.terms, plan.threads) == (lanes, terms, threads)


def test_fb_probe_build_is_its_own_library():
    from pytorch_hmm_tpu_torch.ops import _build, hsmm_smallk

    plain = _build.library_path("hsmm_smallk")
    probe = _build.library_path("hsmm_smallk", hsmm_smallk.PROBE_DEFINES)
    assert probe != plain and probe.name.startswith("libhsmm_smallk-")
