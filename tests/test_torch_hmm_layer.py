"""The general-K slice as a whole: ``HMM``, ``HMMLayer`` and
``GaussianHMMLayer`` of the torch port vs their JAX twins, on the same
numpy inputs and the same weights (carried across with ``bridge``), at
K=12 (the small-K kernels' range) and K=64 (the general-K kernels'), on
the CPU; and what they are built from: the two matrix builders,
``viterbi_associative`` / ``viterbi_blocked``, sampling, the likelihood
Functions above 32 states and the ξ product form.

Both sides run true f32 on the CPU (JAX takes its XLA scans off the TPU,
its products at ``Precision.HIGHEST``; torch's TF32 switches touch only
CUDA). Paths are identical; each tolerance is stated at its assert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu import core as jcore
from pytorch_hmm_tpu import ops as jops
from pytorch_hmm_tpu import utils as jutils
from pytorch_hmm_tpu.core.viterbi import viterbi_blocked as jviterbi_blocked
from pytorch_hmm_tpu.hmm import HMM as JaxHMM
from pytorch_hmm_tpu.models import GaussianHMMLayer as JaxGaussian
from pytorch_hmm_tpu.models import HMMLayer as JaxHMMLayer
from pytorch_hmm_tpu.models import MixtureGaussianHMMLayer as JaxGMM
from pytorch_hmm_tpu_torch import (
    HMM,
    GaussianHMMLayer,
    HMMJax,
    HMMLayer,
    HMMPyTorch,
    MixtureGaussianHMMLayer,
    bridge,
    core,
    ops,
    utils,
)

B, T, D = 3, 60, 8
LENGTHS = [60, 23, 1]
WIDTHS = [12, 64]


def _flat(state) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(state)}


def _probs(K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.01, 1.0, size=(B, T, K)).astype(np.float32)


# -- matrix builders, sampling, parallel Viterbi -------------------------------


@pytest.mark.parametrize("kind", ["ergodic", "left_to_right", "left_to_right_skip", "circular"])
@pytest.mark.parametrize("K", [5, 64])
def test_transition_builders_match_jax(kind, K):
    got = utils.create_transition_matrix(K, kind, self_loop_prob=0.6)
    want = jutils.create_transition_matrix(K, kind, self_loop_prob=0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    np.testing.assert_array_equal(utils.create_left_to_right_matrix(K).numpy(),
                                  np.asarray(jutils.create_left_to_right_matrix(K)))
    with pytest.raises(ValueError, match="Unknown transition_type"):
        utils.create_transition_matrix(K, "banded")


@pytest.mark.parametrize("method", ["associative", "blocked"])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
@pytest.mark.parametrize("K", [5, 40])
def test_parallel_viterbi_is_bit_identical_to_jax(method, lengths, K):
    """Paths and scores bit for bit: the associative scan combines in
    ``jax.lax.associative_scan``'s order, the blocked one folds and
    rescans as the reference does."""
    rng = np.random.default_rng(K)
    lo = rng.normal(size=(B, T, K)).astype(np.float32)
    la = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    ln_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ln_t = None if lengths is None else torch.tensor(lengths)
    jfn = jcore.viterbi_associative if method == "associative" else jviterbi_blocked
    tfn = core.viterbi_associative if method == "associative" else core.viterbi_blocked
    s_j, c_j = jfn(jnp.asarray(lo), jnp.asarray(la), jnp.asarray(lp), lengths=ln_j)
    s_t, c_t = tfn(*(torch.from_numpy(a) for a in (lo, la, lp)), lengths=ln_t)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    s_0, c_0 = core.viterbi(*(torch.from_numpy(a) for a in (lo, la, lp)), ln_t)
    assert torch.equal(s_t, s_0)


def test_sampling_has_the_chains_statistics():
    """Torch and JAX draw different bits from a seed, so the samples are
    held to the chain itself: initial-state and transition frequencies of
    4000 paths of 50 frames within 5 standard errors of ``p0`` and
    ``P``; the one-hot observations name the states."""
    K = 4
    P = torch.tensor([[0.7, 0.2, 0.1, 0.0], [0.1, 0.6, 0.2, 0.1],
                      [0.0, 0.3, 0.5, 0.2], [0.25, 0.25, 0.25, 0.25]])
    p0 = torch.tensor([0.1, 0.2, 0.3, 0.4])
    hmm = HMM(P, p0, device="cpu")
    obs, states = hmm.sample(50, batch_size=4000, generator=torch.Generator().manual_seed(3))
    assert states.dtype == torch.int32 and states.shape == (4000, 50)
    assert torch.equal(obs.argmax(-1).to(torch.int32), states) and obs.sum(-1).eq(1).all()
    n0 = 4000
    f0 = torch.bincount(states[:, 0].long(), minlength=K).double() / n0
    assert ((f0 - p0.double()).abs() <= 5 * torch.sqrt(p0 * (1 - p0) / n0) + 1e-9).all()
    prev, nxt = states[:, :-1].reshape(-1).long(), states[:, 1:].reshape(-1).long()
    counts = torch.zeros(K, K, dtype=torch.float64).index_put_((prev, nxt), torch.ones(prev.numel(),
                                                                dtype=torch.float64), accumulate=True)
    rows = counts.sum(-1, keepdim=True)
    se = torch.sqrt(P.double() * (1 - P.double()) / rows)
    assert ((counts / rows - P.double()).abs() <= 5 * se + 1e-9).all()
    assert (counts[P == 0] == 0).all()
    # The same generator seed repeats the draw; the default seed is 0.
    again = hmm.sample(50, batch_size=4000, generator=torch.Generator().manual_seed(3))[1]
    assert torch.equal(again, states)
    assert torch.equal(hmm.sample(7, 2)[1],
                       hmm.sample(7, 2, generator=torch.Generator().manual_seed(0))[1])


# -- HMM -----------------------------------------------------------------------


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_hmm_matches_jax(K, lengths):
    """Posteriors within atol 1e-5, log alpha / log beta within rtol 1e-5
    (f32 scans of 60 frames, summed in another order), likelihoods
    within rtol 1e-5, decoded paths identical for every method."""
    P = np.asarray(jutils.create_left_to_right_matrix(K, 0.6)) + 0.01
    jh, th = JaxHMM(P), HMM(P, device="cpu")
    assert HMMJax is HMM and HMMPyTorch is HMM
    np.testing.assert_allclose(th.P.numpy(), np.asarray(jh.P), rtol=1e-6)   # row sums round apart
    obs = _probs(K, seed=K)
    ln_j = None if lengths is None else jnp.asarray(lengths)
    ln_t = None if lengths is None else torch.tensor(lengths)
    got = th.forward_backward(obs, lengths=ln_t)
    want = jh.forward_backward(jnp.asarray(obs), lengths=ln_j)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(np.log(g[g > 0]), np.log(w[g > 0]), rtol=1e-5, atol=1e-4)
    for method in ("scan", "associative", "blocked"):
        s_t, c_t = th.viterbi_decode(obs, method=method, lengths=ln_t)
        s_j, c_j = jh.viterbi_decode(jnp.asarray(obs), method=method, lengths=ln_j)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6)
    for method in ("scan", "associative"):
        np.testing.assert_allclose(
            th.compute_likelihood(obs, method=method, lengths=ln_t).numpy(),
            np.asarray(jh.compute_likelihood(jnp.asarray(obs), method=method, lengths=ln_j)),
            rtol=1e-5)
    # Unbatched in, unbatched out.
    post, _, _ = th.forward_backward(obs[0])
    assert post.shape == (T, K) and th.viterbi_decode(obs[0])[0].shape == (T,)
    assert th.compute_likelihood(obs[0]).shape == ()


def test_hmm_rejects_bad_shapes():
    with pytest.raises(ValueError, match="square"):
        HMM(np.ones((3, 4)), device="cpu")
    with pytest.raises(ValueError, match=r"\(T,K\) or \(B,T,K\)"):
        HMM(np.ones((3, 3)), device="cpu").viterbi_decode(np.ones(3))


# -- HMMLayer ------------------------------------------------------------------


def _layer_pair(K, learnable=True, **kw):
    jl = JaxHMMLayer(K, learnable_transitions=learnable, rngs=nnx.Rngs(0), **kw)
    tl = HMMLayer(K, learnable_transitions=learnable, device="cpu", **kw)
    tl.load_state_dict(bridge.hmm_layer_state_dict(_flat(nnx.state(jl))))
    return jl, tl


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("learnable", [True, False])
def test_hmm_layer_matches_jax(K, learnable):
    """Initial weights equal without the bridge; train-mode posteriors
    within atol 1e-5; eval-mode one-hot alignments, ``align`` paths
    identical and scores within rtol 1e-6; sampling shapes."""
    jl, tl = _layer_pair(K, learnable)
    fresh = HMMLayer(K, learnable_transitions=learnable, device="cpu")
    for k, v in _flat(nnx.state(jl)).items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v, err_msg=k)
    x = np.random.default_rng(K).normal(size=(B, T, K)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tl(xt).detach().numpy(), np.asarray(jl(xj)), atol=1e-5)
    jl.eval()
    tl.eval()
    post_t, st_t = tl(xt, return_alignment=True)
    post_j, st_j = jl(xj, return_alignment=True)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(post_t.numpy(), np.asarray(post_j))
    s_t, c_t = tl.align(xt[0])
    s_j, c_j = jl.align(xj[0])
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6)
    obs, states = tl.sample(9, 2, generator=torch.Generator().manual_seed(1))
    assert obs.shape == (2, 9, K) and states.shape == (2, 9)
    if not learnable:
        assert "transition_matrix" in dict(tl.named_buffers())
        assert "transition_matrix" not in dict(tl.named_parameters())
        assert set(bridge.hmm_layer_numpy(tl)) == {"transition_matrix", "initial_logits"}


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("supervised", [False, True])
def test_hmm_layer_loss_gradients_match_jax(K, supervised):
    """Loss within rtol 1e-5, every gradient within atol 1e-5, rtol 1e-4
    (f32 autograd through two different scans). The supervised loss
    differentiates through the posteriors of the plain ``core`` on the
    CPU, as the JAX package does off the TPU."""
    jl, tl = _layer_pair(K)
    rng = np.random.default_rng(K + 1)
    x = rng.normal(size=(B, T, K)).astype(np.float32)
    tgt = rng.integers(0, K, size=(B, T)) if supervised else None
    want_v, want_g = nnx.value_and_grad(
        lambda m: m.compute_loss(jnp.asarray(x), None if tgt is None else jnp.asarray(tgt)))(jl)
    loss = tl.compute_loss(torch.from_numpy(x), None if tgt is None else torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    want_g = _flat(want_g)
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_hmm_layer_rejects_wrong_feature_dim():
    with pytest.raises(ValueError, match="feature dim 5 must match num_states 4"):
        HMMLayer(4, device="cpu")(torch.zeros(1, 3, 5))


# -- GaussianHMMLayer ------------------------------------------------------------


def _gaussian_pair(K, cov="diag", learnable=True):
    jl = JaxGaussian(K, D, covariance_type=cov, learnable_transitions=learnable,
                     rngs=nnx.Rngs(0))
    tl = GaussianHMMLayer(K, D, covariance_type=cov, learnable_transitions=learnable,
                          device="cpu")
    tl.load_state_dict(bridge.gaussian_hmm_layer_state_dict(_flat(nnx.state(jl))))
    return jl, tl


def _features(K, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D))
    states = np.minimum(np.arange(T)[None, :] // rng.integers(1, 4, size=(B, 1)), K - 1)
    return (centers[states] + 0.5 * rng.normal(size=(B, T, D))).astype(np.float32)


@pytest.mark.parametrize("K", WIDTHS)
@pytest.mark.parametrize("cov", ["diag", "spherical"])
def test_gaussian_layer_matches_jax(K, cov):
    """Train-mode posteriors within atol 2e-4 (raw alpha + beta reach
    ~1e3 on these features, where one f32 ulp is 1.2e-4; neither side
    shifts its emissions on the CPU), eval-mode one-hot alignments
    identical, the loss within rtol 1e-5 and every gradient within atol
    5e-4, rtol 1e-3 (f32 autograd of two scans: the posteriors' 1e-4
    times squared deviations of up to ~10 in the scale gradients, summed
    over T·B frames)."""
    jl, tl = _gaussian_pair(K, cov)
    x = _features(K, K)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(tl(xt).detach().numpy(), np.asarray(jl(xj)), atol=2e-4)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(xj))(jl)
    loss = tl.compute_loss(xt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    want_g = _flat(want_g)
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], atol=5e-4, rtol=1e-3,
                                   err_msg=name)
    jl.eval()
    tl.eval()
    np.testing.assert_array_equal(tl(xt).numpy(), np.asarray(jl(xj)))
    np.testing.assert_array_equal(tl(xt[0]).numpy(), np.asarray(jl(xj[0])))


def test_gaussian_layer_fixed_transitions_and_refusals():
    jl, tl = _gaussian_pair(12, learnable=False)
    assert "hmm_layer.transition_matrix" in dict(tl.named_buffers())
    assert set(bridge.gaussian_hmm_layer_numpy(tl)) == set(_flat(nnx.state(jl)))
    # Full covariance, once refused: raw (K, D, D) log-scales, zeros (the
    # identity factor) as in the JAX layer, carried by the same bridge.
    jfull = JaxGaussian(4, 3, covariance_type="full", rngs=nnx.Rngs(0))
    full = GaussianHMMLayer(4, 3, covariance_type="full", device="cpu")
    assert full.log_scales.shape == (4, 3, 3) and not full.log_scales.any()
    full.load_state_dict(bridge.gaussian_hmm_layer_state_dict(_flat(nnx.state(jfull))))
    assert set(bridge.gaussian_hmm_layer_numpy(full)) == set(_flat(nnx.state(jfull)))
    with pytest.raises(ValueError, match="Unknown covariance_type"):
        GaussianHMMLayer(4, 3, covariance_type="tied", device="cpu")
    with pytest.raises(KeyError, match="not a GaussianHMMLayer weight"):
        bridge.gaussian_hmm_layer_state_dict({"bias": np.zeros(3)})


# -- the likelihood Functions and EM above 32 states ---------------------------


def _problem(B_, T_, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B_, T_, K)).astype(np.float32),
            np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32),
            np.log(rng.dirichlet(np.ones(K))).astype(np.float32))


@pytest.mark.parametrize("lengths", [None, [50, 33, 1]])
def test_big_k_likelihood_functions_match_jax_custom_vjps(lengths):
    """At K=40 the Functions run ``pallas_forward`` / ``pallas_backward``
    (their plain versions on the CPU) and the ξ product; against
    ``jax.value_and_grad`` of the JAX custom VJPs, their Pallas kernels
    in interpret mode: atol 1e-3, as the JAX package holds its VJPs to
    its scans (tests/test_ops.py)."""
    arrays = _problem(3, 50, 40, seed=4)
    if lengths is None:
        jfn, tfn, ej, et = jops.pallas_log_likelihood, ops.pallas_log_likelihood, (), ()
    else:
        jfn, tfn = jops._pallas_ll_masked, ops._pallas_ll_masked
        ej, et = (jnp.asarray(lengths, jnp.int32),), (torch.tensor(lengths, dtype=torch.int32),)
    want_v, want_g = jax.value_and_grad(lambda *a: jnp.sum(jfn(*a, *ej)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    val = tfn(*args, *et)
    val.sum().backward()
    np.testing.assert_allclose(val.detach().numpy().sum(), float(want_v), atol=1e-3)
    for a, w in zip(args, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("lengths", [None, [40, 17, 1]])
@pytest.mark.parametrize("band", [False, True], ids=["dense", "-inf band"])
def test_xi_product_matches_the_materialised_sum(lengths, band):
    """``core.xi_sum`` against the exp of the materialised (B, T-1, K, K)
    ξ table summed with the same weights and length mask: from float64
    tables within rtol 1e-9 (the same sum in another order), from f32
    tables within rtol 1e-5, atol 1e-5 of that (f32 tables of 40
    frames, sums of up to ~120 probabilities); a -inf
    band of structural zeros gives exact zeros."""
    K = 36
    rng = np.random.default_rng(8)
    lo = torch.from_numpy(2.0 * rng.normal(size=(B, 40, K)))
    logits = torch.from_numpy(rng.normal(size=(K, K)))
    if band:
        i = torch.arange(K)
        logits = logits.masked_fill((i[None, :] < i[:, None]) | (i[None, :] > i[:, None] + 2),
                                    float("-inf"))
    la = torch.log_softmax(logits, -1)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(size=K)), -1)
    ln = None if lengths is None else torch.tensor(lengths)
    w = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    _, alpha, beta, lz = core.forward_backward(lo, la, lp, ln)
    lxi = alpha[:, :-1, :, None] + la + (lo + beta)[:, 1:, None, :] - lz[:, None, None, None]
    xi = torch.exp(lxi)
    if ln is not None:
        keep = torch.arange(1, 40)[None, :] < ln[:, None]
        xi = torch.where(keep[..., None, None], xi, 0.0)
    want = torch.einsum("b,btij->ij", w, xi)
    got = core.xi_sum(alpha, beta, lo, la, weights=w, lengths=ln)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    f32 = [t.float() for t in (lo, la, lp)]
    _, alpha32, beta32, _ = core.forward_backward(*f32, ln)
    got32 = core.xi_sum(alpha32, beta32, f32[0], f32[1], weights=w.float(), lengths=ln)
    np.testing.assert_allclose(got32.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    if band:
        assert bool((got[torch.isneginf(la)] == 0).all())
    if ln is None:
        lxs = core.xi_expectations(alpha, beta, lo, la, lz)
        np.testing.assert_allclose(core.xi_sum(alpha, beta, lo, la).numpy(),
                                   torch.exp(lxs).sum(0).numpy(), rtol=1e-9, atol=1e-12)


def test_big_k_likelihood_gradients_hold_to_float64_at_speech_scale():
    """Peaked emissions at K=64, T=400 (|log Z| ~ 1e4): the f32
    Function's gradients (plain chains, per-frame posteriors, the ξ
    product) within 1e-4 of each tensor's largest entry from autograd
    through ``core.log_likelihood`` in float64. Posteriors formed with
    ``log Z`` instead were 5e-3 off at T=1000."""
    K, T_ = 64, 400
    rng = np.random.default_rng(12)
    lo = (-50.0 * rng.random(size=(2, T_, K)) - 100.0).astype(np.float32)
    lo[:, np.arange(T_), np.minimum(np.arange(T_) // 7, K - 1)] += 60.0
    p = 0.7 * np.eye(K) + 0.3 * np.eye(K, k=1)
    p[-1, -1] = 1.0
    la = np.log(p + 1e-8).astype(np.float32)
    lp = np.log(np.full(K, 1.0 / K)).astype(np.float32)
    got = [torch.from_numpy(a).requires_grad_(True) for a in (lo, la, lp)]
    ops.pallas_log_likelihood(*got).sum().backward()
    want = [torch.from_numpy(a).double().requires_grad_(True) for a in (lo, la, lp)]
    core.log_likelihood(*want).sum().backward()
    for g, w in zip(got, want):
        err = ((g.grad.double() - w.grad).abs().max() / w.grad.abs().max()).item()
        assert err <= 1e-4, err


def test_mixture_gaussian_above_32_states_matches_jax():
    """``MixtureGaussianHMMLayer`` at S=40: decode paths identical, loss
    within rtol 1e-5 and gradients within atol 1e-4, one ``em_step``
    (the ξ product) within atol 1e-4 on every updated parameter, the
    logits compared as probabilities."""
    S, C, Dg = 40, 2, 5
    jl = JaxGMM(S, Dg, num_components=C, rngs=nnx.Rngs(0))
    names = ["mixture_weights_logits", "means", "cov_params", "transition_logits"]
    tl = MixtureGaussianHMMLayer(S, Dg, num_components=C, device="cpu")
    tl.load_state_dict(bridge.mixture_gaussian_state_dict(
        {n: np.asarray(getattr(jl, n)[...]) for n in names}))
    rng = np.random.default_rng(6)
    centers = 2.0 * rng.normal(size=(S, Dg))
    obs = (centers[(np.arange(T)[None, :] // 3 + rng.integers(0, S, size=(B, 1))) % S]
           + rng.normal(size=(B, T, Dg))).astype(np.float32)
    xj, xt = jnp.asarray(obs), torch.from_numpy(obs)
    s_t, c_t = tl(xt, return_log_probs=True)
    s_j, c_j = jl(xj, return_log_probs=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(xj))(jl)
    loss = tl.compute_loss(xt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-5)
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name][...]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tl.em_step(xt).item(), float(jl.em_step(xj)), rtol=1e-5)
    for name, value in bridge.mixture_gaussian_numpy(tl).items():
        want = np.asarray(getattr(jl, name)[...])
        if name.endswith("_logits"):
            value, want = (np.asarray(jax.nn.softmax(v, -1)) for v in (value, want))
        np.testing.assert_allclose(value, want, atol=1e-4, err_msg=name)
