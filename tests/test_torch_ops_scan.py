"""The general-K chain kernels' plain versions (rows 8, 9 and 13 of the
JAX package's kernels) against ``pytorch_hmm_tpu.ops.scan``'s
``pallas_forward`` / ``pallas_backward`` / ``pallas_viterbi`` in
interpret mode, on the same numpy inputs, and the dispatch that sends
33 ≤ K ≤ 1024 to them.

Tolerances: sums within atol 5e-4 (the JAX kernel tests' own against
their scans, tests/test_ops.py); both sides compute the same prob-space
step in true f32 (JAX ``Precision.HIGHEST``; torch's CPU products).
Viterbi paths and scores are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_hmm_tpu.ops import scan as jscan
from pytorch_hmm_tpu_torch import core, ops
from pytorch_hmm_tpu_torch.ops import scan

ATOL = 5e-4


def _problem(B, T, K, seed=None, lengths=None):
    rng = np.random.default_rng(B * T if seed is None else seed)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    return lo, la, lp, None if lengths is None else np.asarray(lengths, np.int32)


def _pair(arrays):
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    t = [None if a is None else torch.from_numpy(a) for a in arrays]
    return j, t


CASES = {
    "B20 T257 K64": _problem(20, 257, 64),
    "B2 T48 K256": _problem(2, 48, 256),
    "ragged K40": _problem(5, 90, 40, seed=7, lengths=[90, 31, 64, 1, 77]),
    "T=1": _problem(3, 1, 33, seed=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_plain_version_matches_jax_kernel(case):
    (lo, la, lp, ln), (tlo, tla, tlp, tln) = _pair(CASES[case])
    a_j, z_j = jscan.pallas_forward(lo, la, lp, ln)
    a_t, z_t = scan.pallas_forward_reference(tlo, tla, tlp, tln)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=ATOL)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_version_matches_jax_kernel(case):
    (lo, la, _, ln), (tlo, tla, _, tln) = _pair(CASES[case])
    b_j = jscan.pallas_backward(lo, la, ln)
    b_t = scan.pallas_backward_reference(tlo, tla, tln)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_viterbi_plain_version_matches_jax_kernel(case):
    (lo, la, lp, ln), (tlo, tla, tlp, tln) = _pair(CASES[case])
    s_j, c_j = jscan.pallas_viterbi(lo, la, lp, ln)
    s_t, c_t = scan.pallas_viterbi_reference(tlo, tla, tlp, tln)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_viterbi_ties_match_jax_kernel():
    """All ties, at K=40: the lowest state index wins everywhere."""
    K = 40
    lo = np.zeros((2, 30, K), np.float32)
    la = np.full((K, K), -np.log(K), np.float32)
    lp = np.full((K,), -np.log(K), np.float32)
    s_j, c_j = jscan.pallas_viterbi(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp))
    s_t, c_t = scan.pallas_viterbi_reference(*(torch.from_numpy(a) for a in (lo, la, lp)))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_left_to_right_matches_core_on_finite_entries():
    """A left-to-right matrix through ``safe_log`` (K=48): the
    prob-space chains underflow to -inf where ``core`` keeps ~-100;
    every entry ``core`` puts above -60 agrees within atol 5e-4, every
    -inf sits where ``core`` is below -60, and the posteriors agree
    within atol 1e-4 (alpha + beta reach ~1e3 here, where one f32 ulp is
    ~6e-5)."""
    K, B, T = 48, 3, 120
    rng = np.random.default_rng(5)
    p = 0.6 * np.eye(K) + 0.4 * np.eye(K, k=1)
    p[-1, -1] = 1.0
    la = torch.log(torch.from_numpy(p).float() + 1e-8)
    lp = torch.log(torch.full((K,), 1.0 / K) + 1e-8)
    lo = torch.from_numpy((3.0 * rng.normal(size=(B, T, K))).astype(np.float32))
    a_t, z_t = scan.pallas_forward_reference(lo, la, lp)
    b_t = scan.pallas_backward_reference(lo, la)
    a0, z0 = core.forward_log(lo, la, lp)
    b0 = core.backward_log(lo, la)
    for got, want in ((a_t, a0), (b_t, b0)):
        high = want > -60
        np.testing.assert_allclose(got[high].numpy(), want[high].numpy(), atol=ATOL)
        assert bool((want[torch.isneginf(got)] < -60).all())
    np.testing.assert_allclose(z_t.numpy(), z0.numpy(), atol=ATOL)
    g_t = torch.softmax(a_t + b_t, -1)
    g_0 = torch.softmax(a0 + b0, -1)
    np.testing.assert_allclose(g_t.numpy(), g_0.numpy(), atol=1e-4)


@pytest.mark.parametrize("K,ok", [(32, False), (33, True), (64, True), (1024, True), (1025, False)])
def test_scan_supported_bounds(K, ok):
    assert scan.scan_supported(K) is ok
    assert scan.MAX_K == 1024


def test_cpu_tensors_never_launch():
    (_, _, _, _), (tlo, tla, tlp, _) = _pair(CASES["ragged K40"])
    before = (scan.pallas_forward.launches, scan.pallas_backward.launches,
              scan.pallas_viterbi.launches)
    scan.pallas_forward(tlo, tla, tlp)
    scan.pallas_backward(tlo, tla)
    scan.pallas_viterbi(tlo, tla, tlp)
    ops.auto_forward_backward(tlo, tla, tlp)
    after = (scan.pallas_forward.launches, scan.pallas_backward.launches,
             scan.pallas_viterbi.launches)
    assert before == after


@pytest.mark.parametrize("fn", ["pallas_forward", "pallas_backward", "pallas_viterbi"])
def test_kernel_wrappers_refuse_what_they_cannot_launch(fn):
    """Off the CPU the wrappers validate before any work: K above 1024
    and a non-CUDA device raise (meta tensors stand in for CUDA ones)."""
    f = getattr(scan, fn)

    def call(K):
        lo = torch.empty(2, 5, K, device="meta")
        la = torch.empty(K, K, device="meta")
        args = (lo, la) if fn == "pallas_backward" else (lo, la, torch.empty(K, device="meta"))
        return f(*args)

    with pytest.raises(ValueError, match="1 <= K <= 1024"):
        call(1025)
    with pytest.raises(ValueError, match="runs on CPU or CUDA"):
        call(64)


@pytest.mark.parametrize("fn,wrapper", [("auto_forward", "pallas_forward"),
                                        ("auto_forward_backward", "pallas_forward"),
                                        ("auto_log_likelihood", "pallas_forward"),
                                        ("auto_viterbi", "pallas_viterbi")])
def test_dispatch_sends_big_k_to_the_kernels(fn, wrapper):
    """33 ≤ K ≤ 1024 with static transitions reaches the general-K
    kernel wrapper off the CPU (which refuses the meta device): no
    fallback to the plain scans."""
    with pytest.raises(ValueError, match=f"{wrapper} runs on CPU or CUDA"):
        getattr(ops, fn)(torch.empty(2, 5, 33, device="meta"), torch.empty(33, 33, device="meta"),
                         torch.empty(33, device="meta"))


def test_dispatch_runs_plain_core_where_no_kernel_exists():
    """K > 1024, or time-varying transitions above 32 states: the JAX
    package has no kernel either, so the plain ``core`` runs on the
    tensors' own device (meta: shapes only)."""
    lo = torch.empty(2, 3, 1025, device="meta")
    alpha, log_z = ops.auto_forward(lo, torch.empty(1025, 1025, device="meta"),
                                    torch.empty(1025, device="meta"))
    assert alpha.device.type == "meta" and alpha.shape == lo.shape and log_z.shape == (2,)
    lo = torch.empty(2, 3, 40, device="meta")
    la = torch.empty(2, 3, 40, 40, device="meta")
    states, _ = ops.auto_viterbi(lo, la, torch.empty(40, device="meta"))
    assert states.device.type == "meta" and states.shape == (2, 3)
    ll = ops.auto_log_likelihood(lo, la, torch.empty(40, device="meta"))
    assert ll.device.type == "meta" and ll.shape == (2,)
