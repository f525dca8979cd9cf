"""The long-sequence prob-space chains (rows 10, 11 and 12 of the JAX
package's kernels): their plain versions against
``pytorch_hmm_tpu.ops.scan``'s ``pallas_forward_prob`` /
``pallas_backward_prob`` / ``pallas_fb_prob`` in interpret mode on the
same numpy inputs, against the port's ``core`` in float64, and the gate
and dispatch that send long unragged sequences with finite transitions
to them.

Tolerances: against the JAX kernels atol 2e-3 at (3, 300, 11) and 3e-3
at the edge shapes, the JAX kernel tests' own against their scans
(tests/test_ops.py); both sides run the same scaled chain in true f32,
rescaled at the same frames, with sums in another order. Against
``core`` in float64 the chains are exact up to float64 rounding: atol
1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_hmm_tpu.ops as jops
from pytorch_hmm_tpu.ops import scan as jscan
from pytorch_hmm_tpu_torch import core, ops
from pytorch_hmm_tpu_torch.ops import scan


def _problem(B, T, K, seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lo = (scale * rng.normal(size=(B, T, K))).astype(dtype)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(dtype)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(dtype)
    return lo, la, lp


def _pair(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _chains(mod, lo, la, lp, rs, reference=False):
    """``{name: outputs}`` of the three chains of ``mod`` (the JAX scan
    module, or the port's plain versions)."""
    sfx = "_reference" if reference else ""
    fwd = getattr(mod, "pallas_forward_prob" + sfx)(lo, la, lp, rs=rs)
    bwd = getattr(mod, "pallas_backward_prob" + sfx)(lo, la, rs=rs)
    fb = getattr(mod, "pallas_fb_prob" + sfx)(lo, la, lp, rs=rs)
    return {"forward": fwd, "backward": (bwd,), "fb": fb}


def _assert_chains_match_jax(arrays, rs, atol):
    (jlo, jla, jlp), (tlo, tla, tlp) = _pair(arrays)
    want = _chains(jscan, jlo, jla, jlp, rs)
    got = _chains(scan, tlo, tla, tlp, rs, reference=True)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)


@pytest.mark.parametrize("rs", [4, 8])
def test_plain_versions_match_jax_kernels(rs):
    _assert_chains_match_jax(_problem(3, 300, 11, seed=3, scale=3.0), rs, atol=2e-3)


@pytest.mark.parametrize("B,T,K", [(9, 129, 100), (2, 300, 128), (5, 257, 64), (1, 128, 16)])
def test_plain_versions_match_jax_kernels_at_edge_shapes(B, T, K):
    """Odd batch, time and state sizes: the TPU kernels' tile padding and
    chunk tails, and K at the 128-state bound."""
    _assert_chains_match_jax(_problem(B, T, K, seed=B + T + K, scale=2.0), 8, atol=3e-3)


@pytest.mark.parametrize("rs", [1, 5, 8])
@pytest.mark.parametrize("T", [1, 2, 77])
def test_plain_versions_match_core_in_float64(rs, T):
    """Any rescale interval, T=1 and a T no interval divides: the chains
    equal ``core.forward_log`` / ``backward_log`` up to float64
    rounding (row-stochastic transitions in float64, so the backward's
    all-ones start is exact)."""
    lo, la, lp = (torch.from_numpy(a) for a in _problem(3, T, 9, seed=T, scale=3.0,
                                                         dtype=np.float64))
    a, z = scan.pallas_forward_prob_reference(lo, la, lp, rs=rs)
    b = scan.pallas_backward_prob_reference(lo, la, rs=rs)
    a0, z0 = core.forward_log(lo, la, lp)
    b0 = core.backward_log(lo, la)
    for got, want in ((a, a0), (z, z0), (b, b0)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-9)
    fa, fb, fz = scan.pallas_fb_prob_reference(lo, la, lp, rs=rs)
    assert torch.equal(fa, a) and torch.equal(fb, b) and torch.equal(fz, z)


def test_finite_left_to_right_chain_keeps_its_mass():
    """A finite left-to-right matrix through ``safe_log`` (off-band
    entries ~-18.4, rows renormalized) with emissions mismatched by up
    to 12 nats: the scaled chains never underflow, and alpha and beta
    stay within 1e-9 of ``core`` in float64 everywhere."""
    K, T = 40, 300
    rng = np.random.default_rng(11)
    p = 0.6 * np.eye(K) + 0.4 * np.eye(K, k=1)
    p[-1, -1] = 1.0
    la = torch.log_softmax(torch.log(torch.from_numpy(p) + 1e-8), dim=-1)
    lp = torch.log(torch.full((K,), 1.0 / K, dtype=torch.float64))
    lo = torch.from_numpy(-12.0 * rng.random(size=(2, T, K)))
    a, _ = scan.pallas_forward_prob_reference(lo, la, lp)
    b = scan.pallas_backward_prob_reference(lo, la)
    np.testing.assert_allclose(a.numpy(), core.forward_log(lo, la, lp)[0].numpy(), atol=1e-9)
    np.testing.assert_allclose(b.numpy(), core.backward_log(lo, la).numpy(), atol=1e-9)


def test_split_tables_compose_to_the_tables_and_keep_posteriors_at_long_range():
    """``pallas_fb_prob_split``'s tables plus their per-frame shifts are
    the plain chains' tables bit for bit; at speech-like magnitudes over
    1100 frames (|log alpha| ~ 1e5, one f32 ulp 0.008) the posteriors of
    the prob route, taken from the split tables, stay within 1e-5 of
    float64, where the summed tables' own rounding puts more than 1e-3
    into them."""
    lo, la, lp = (torch.from_numpy(a) for a in _problem(2, 300, 40, seed=8))
    rel_a, sh_a, rel_b, sh_b = scan.pallas_fb_prob_split(lo, la, lp)
    alpha, beta, _ = scan.pallas_fb_prob(lo, la, lp)
    assert sh_a.shape == sh_b.shape == (2, 300)
    assert torch.equal(rel_a + sh_a[..., None], alpha) and torch.equal(rel_b + sh_b[..., None], beta)
    lo, la, lp = (torch.from_numpy(a) for a in _problem(2, 1100, 40, seed=8))
    big = 30.0 * lo - 100.0
    gamma = torch.exp(ops._shifted_forward_backward(big, la, lp, route="prob")[0])
    g64 = torch.exp(core.forward_backward(big.double(), la.double(), lp.double())[0])
    np.testing.assert_allclose(gamma.numpy(), g64.numpy(), atol=1e-5)
    a, b, _ = scan.pallas_fb_prob_reference(big, la, lp)
    raw = torch.softmax(a + b, -1).double()
    assert (raw - g64).abs().max() > 1e-3


@pytest.mark.parametrize("fn", ["pallas_forward_prob", "pallas_backward_prob", "pallas_fb_prob"])
def test_wrappers_refuse_what_they_cannot_launch(fn):
    """A rescale interval below 1 raises on every device; off the CPU the
    wrappers validate before any work: K above 128 and a non-CUDA device
    raise (meta tensors stand in for CUDA ones)."""
    f = getattr(scan, fn)

    def call(K, device="meta", rs=8):
        lo = torch.zeros(2, 5, K, device=device)
        la = torch.zeros(K, K, device=device)
        args = (lo, la) if fn == "pallas_backward_prob" else (lo, la, torch.zeros(K, device=device))
        return f(*args, rs=rs)

    with pytest.raises(ValueError, match="1 <= K <= 128"):
        call(129)
    with pytest.raises(ValueError, match=f"{fn} runs on CPU or CUDA"):
        call(64)
    with pytest.raises(ValueError, match="rescale interval"):
        call(4, device="cpu", rs=0)


@pytest.mark.parametrize("K,ok", [(0, False), (1, True), (12, True), (128, True), (129, False)])
def test_prob_supported_bounds(K, ok):
    assert scan.prob_supported(K) is ok
    assert scan.PROB_MAX_K == 128 and ops.PROB_MIN_T == 1024


def test_cpu_tensors_never_launch():
    _, (lo, la, lp) = _pair(_problem(2, 30, 40, seed=1))
    fns = (scan.pallas_forward_prob, scan.pallas_backward_prob, scan.pallas_fb_prob)
    before = [f.launches for f in fns]
    scan.pallas_forward_prob(lo, la, lp)
    scan.pallas_backward_prob(lo, la)
    scan.pallas_fb_prob(lo, la, lp)
    scan.pallas_fb_prob_split(lo, la, lp)
    assert [f.launches for f in fns] == before


# -- the gate and the dispatch -----------------------------------------------------


def _route_case(B=2, T=1024, K=64, neg_inf=False):
    lo, la, lp = (torch.from_numpy(a) for a in _problem(B, T, K, seed=K))
    if neg_inf:
        la = la.clone()
        la[0, -1] = float("-inf")
    return lo, la, lp


@pytest.mark.parametrize("case,posteriors,want", [
    ("finite", False, "prob"),
    ("finite", True, "prob"),
    ("-inf entry", False, "scan"),
    ("-inf entry", True, "scan"),
    ("T=1023", False, "scan"),
    ("ragged", False, "scan"),
    ("K=129", False, "scan"),
    ("K=12", False, "smallk"),
    ("K=12", True, "prob"),
    ("K=12 T=1023", True, "smallk"),
    ("K=12 -inf entry", True, "smallk"),
    ("time-varying K=40", True, "plain"),
])
def test_sum_route_holds_both_sides_of_every_gate_condition(case, posteriors, want):
    """The JAX package's ``_prob_ok``: unragged, static finite ``log_a``,
    T ≥ 1024, K ≤ 128; above 32 states on every route, at K ≤ 32 only
    for posteriors (``auto_forward_backward``)."""
    lengths = None
    if case.split()[0] == "K=12":
        lo, la, _ = _route_case(T=1023 if "1023" in case else 1024, K=12,
                                neg_inf="-inf" in case)
    elif case == "time-varying K=40":
        lo, la, _ = _route_case(T=1024, K=40)
        la = la.expand(2, 1024, 40, 40)
    else:
        lo, la, _ = _route_case(T=1023 if case == "T=1023" else 1024,
                                K=129 if case == "K=129" else 64, neg_inf=case == "-inf entry")
        if case == "ragged":
            lengths = torch.tensor([1024, 7], dtype=torch.int32)
    assert ops._sum_route(lo, la, lengths, posteriors=posteriors) == want


def _meta(B, T, K, requires_grad=False):
    return (torch.empty(B, T, K, device="meta", requires_grad=requires_grad),
            torch.empty(K, K, device="meta"), torch.empty(K, device="meta"))


@pytest.mark.parametrize("fn,K,grad,finite,wrapper", [
    ("auto_forward", 64, False, True, "pallas_forward_prob"),
    ("auto_forward", 64, False, False, "pallas_forward"),
    ("auto_forward", 12, False, True, "hsmm_smallk_forward"),
    ("auto_forward_backward", 64, False, True, "pallas_fb_prob"),
    ("auto_forward_backward", 12, False, True, "pallas_fb_prob"),
    ("auto_forward_backward", 64, False, False, "pallas_forward"),
    ("auto_forward_backward", 12, False, False, "fbsum_smallk"),
    ("auto_log_likelihood", 64, True, True, "pallas_fb_prob"),
    ("auto_log_likelihood", 64, False, True, "pallas_forward_prob"),
    ("auto_log_likelihood", 64, True, False, "pallas_forward"),
    ("auto_log_likelihood", 12, True, True, "hsmm_smallk_forward"),
])
def test_dispatch_reaches_the_routed_wrapper(monkeypatch, fn, K, grad, finite, wrapper):
    """Off the CPU each entry point reaches the wrapper of its route,
    which refuses the meta device (no fallback); the finiteness read is
    stood in for, as meta tensors hold no values. A likelihood that
    records no gradient runs row 10 alone; one that does runs row 12."""
    monkeypatch.setattr(ops, "_finite", lambda log_a: finite)
    with pytest.raises(ValueError, match=f"{wrapper} runs on CPU or CUDA"):
        getattr(ops, fn)(*_meta(2, 1024, K, requires_grad=grad))


def test_gate_reads_finiteness_only_when_the_rest_holds(monkeypatch):
    """The one device sync per call is spent only on problems every
    other condition admits."""
    reads = []
    monkeypatch.setattr(ops, "_finite", lambda log_a: reads.append(1) or True)
    for shape in ((2, 1023, 64), (2, 1024, 12), (2, 1024, 200)):
        ops._sum_route(*_meta(*shape)[:2])
    ops._sum_route(*_meta(2, 1024, 64)[:2], lengths=torch.ones(2, dtype=torch.int32))
    assert reads == []
    assert ops._sum_route(*_meta(2, 1024, 64)[:2]) == "prob" and reads == [1]


def test_shifted_forward_backward_prob_route_matches_jax_kernel_path(monkeypatch):
    """The CUDA branch of ``auto_forward_backward`` at K=12, T=1030 (row
    12 ahead of ``fbsum_smallk``, emissions at speech-like magnitudes),
    run on CPU tensors through the plain versions, against JAX's TPU
    branch (``pallas_fb_prob`` in interpret mode). Posteriors within
    2e-3; alpha, beta and log Z within 2e-3 plus 4 f32 ulps of the
    re-added shift (~1e5 here)."""
    lo, la, lp = _problem(2, 1030, 12, seed=5)
    lo = 30.0 * lo - 100.0
    monkeypatch.setattr(jops, "pallas_available", lambda num_states: True)
    want = jops.auto_forward_backward(*(jnp.asarray(a) for a in (lo, la, lp)))
    tlo, tla, tlp = (torch.from_numpy(a) for a in (lo, la, lp))
    assert ops._sum_route(tlo, tla, posteriors=True) == "prob"
    got = ops._shifted_forward_backward(tlo, tla, tlp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3)
    atol = 2e-3 + 4 * float(np.spacing(np.float32(np.abs(np.asarray(want[3])).max())))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_likelihood_function_on_the_prob_route_matches_jax_custom_vjp():
    """``pallas_log_likelihood`` at (2, 1030, 40), on the prob route
    (``pallas_fb_prob``'s plain version, the saved beta, the ξ product),
    against ``jax.value_and_grad`` of the JAX custom VJP, which takes
    ``pallas_fb_prob`` in interpret mode there. atol 1e-3 as the JAX
    package holds its VJPs to its scans (tests/test_ops.py); the value
    within 2e-3 (log Z ~ -2.5e3, one f32 ulp 2.4e-4)."""
    arrays = _problem(2, 1030, 40, seed=4)
    tl = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    assert ops._sum_route(tl[0], tl[1]) == "prob"
    want_v, want_g = jax.value_and_grad(lambda *a: jnp.sum(jops.pallas_log_likelihood(*a)),
                                        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    val = ops.pallas_log_likelihood(*tl)
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy().sum(), float(want_v), atol=2e-3)
    for a, w in zip(tl, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-3)
