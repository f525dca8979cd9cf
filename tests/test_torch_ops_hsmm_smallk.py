"""``hsmm_smallk_forward`` / ``hsmm_smallk_backward`` port at duration
D = 1: the plain versions vs the JAX Pallas kernels in interpret mode,
with a non-zero ``log_dur[:, 0]`` and ragged lengths; atol 2e-4 (the
JAX kernel tests' tolerance), valid frames only when ragged. D > 1 is
not ported and must raise on any device. The CUDA kernels are checked
against the same plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_backward as jax_backward
from pytorch_hmm_tpu.ops.hsmm_smallk import hsmm_smallk_forward as jax_forward
from pytorch_hmm_tpu_torch import ops
from pytorch_hmm_tpu_torch.ops.hsmm_smallk import (
    hsmm_smallk_backward,
    hsmm_smallk_backward_reference,
    hsmm_smallk_forward,
    hsmm_smallk_forward_reference,
    hsmm_smallk_supported,
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
def test_duration_above_one_raises_on_any_device(device):
    """General D (ROADMAP queue 1 item 6) raises before any work, on the
    CPU as on CUDA."""
    lo, la, lp = (torch.zeros(s, device=device) for s in ((2, 10, 4), (4, 4), (4,)))
    ld2 = torch.zeros(4, 2, device=device)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        hsmm_smallk_forward(lo, la, lp, ld2)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        hsmm_smallk_backward(lo, la, ld2)


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
    assert hsmm_smallk_supported(1, 1, 1) and hsmm_smallk_supported(32, 1, 4096)
    assert not hsmm_smallk_supported(33, 1, 1)
    assert not hsmm_smallk_supported(12, 2, 32)


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
