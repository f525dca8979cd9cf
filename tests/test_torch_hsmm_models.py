"""The duration models of the torch port against their JAX twins, with
the same weights carried across by ``bridge``, on the same numpy inputs,
plus the ``ops`` duration-model dispatch.

Both sides run f32 on the CPU, where the JAX models take their
``core.hsmm`` scans and the port its plain ``core.hsmm``. Tolerances:
decode paths identical and scores within rtol 1e-6 (the emission scores
of the two libraries differ in their last bit; on identical log-obs the
segment DP is bit-identical, ``tests/test_torch_hsmm_core.py``);
log-likelihoods atol 1e-4 (f32
sums of ~T·F emission terms); gradients and one ``em_step``'s parameters
atol 1e-4 and rtol 1e-4 (f32 sufficient statistics summed in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu.models.hsmm import DurationConstrainedHMM as JaxDC
from pytorch_hmm_tpu.models.hsmm import HSMMLayer as JaxHSMM
from pytorch_hmm_tpu.models.semi_markov import AdaptiveDurationHSMM as JaxAdaptive
from pytorch_hmm_tpu.models.semi_markov import SemiMarkovHMM as JaxSemiMarkov
from pytorch_hmm_tpu_torch import (
    AdaptiveDurationHSMM,
    DurationConstrainedHMM,
    HSMMLayer,
    SemiMarkovHMM,
    bridge,
    core,
    ops,
)

S, F, D = 4, 5, 8
B, T = 3, 40
LENGTHS = [40, 17, 3]
TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(model) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(nnx.state(model))}


@pytest.fixture(scope="module")
def obs():
    """Segments of a walk over S Gaussian centres."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(S, F))
    states = (np.arange(T)[None, :] // rng.integers(3, 9, size=(B, 1))) % S
    return (centers[states] + rng.normal(size=(B, T, F))).astype(np.float32)


def _hsmm_pair(dist, learnable=True, min_duration=1):
    kw = dict(duration_distribution=dist, max_duration=D, learnable_duration_params=learnable,
              min_duration=min_duration)
    jl = JaxHSMM(S, F, rngs=nnx.Rngs(0), **kw)
    tl = HSMMLayer(S, F, device="cpu", **kw)
    tl.load_state_dict(bridge.hsmm_layer_state_dict(_flat(jl)))
    return jl, tl


HSMM_CASES = [("gamma", True), ("gamma", False), ("poisson", True), ("poisson", False),
              ("weibull", True), ("weibull", False)]


@pytest.mark.parametrize("dist,learnable", HSMM_CASES)
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_hsmm_layer_decode_likelihood_posteriors_match_jax(obs, dist, learnable, lengths):
    jl, tl = _hsmm_pair(dist, learnable)
    jx, tx = jnp.asarray(obs), torch.from_numpy(obs)
    len_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    len_t = None if lengths is None else torch.tensor(lengths)
    s_j, c_j = jl(jx, len_j)
    s_t, c_t = tl(tx, len_t)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6)
    np.testing.assert_allclose(tl.log_likelihood(tx, len_t).detach().numpy(),
                               np.asarray(jl.log_likelihood(jx, len_j)), atol=1e-4)
    p_j, p_t = jl.posteriors(jx, len_j), tl.posteriors(tx, len_t)
    for key in ("gamma", "segment_end", "segment_start", "log_z"):
        np.testing.assert_allclose(p_t[key].numpy(), np.asarray(p_j[key]), atol=1e-4, err_msg=key)


@pytest.mark.parametrize("dist,learnable", HSMM_CASES)
def test_hsmm_layer_gradients_and_em_step_match_jax(obs, dist, learnable):
    jl, tl = _hsmm_pair(dist, learnable, min_duration=2)
    jx, tx = jnp.asarray(obs), torch.from_numpy(obs)
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(jx))(jl)
    loss = tl.compute_loss(tx)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-6)
    names = [n for n, _ in tl.named_parameters()]
    assert set(names) == set(_flat(nnx.state(jl, nnx.Param)))
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name][...]), **TOL,
                                   err_msg=name)
    want_ll, got_ll = jl.em_step(jx), tl.em_step(tx)
    np.testing.assert_allclose(got_ll.item(), float(want_ll), rtol=1e-6)
    after, want = bridge.hsmm_layer_numpy(tl), _flat(jl)
    assert set(after) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(after[key], value, **TOL, err_msg=key)


@pytest.mark.parametrize("learnable", [True, False])
def test_get_model_info_counts_buffers_where_the_reference_raises(learnable):
    """With fixed durations the JAX ``get_model_info`` raises
    (``nnx.split(self, nnx.Param)`` leaves the duration Buffers over);
    the port counts ``parameters()`` plus the duration buffers."""
    jl, tl = _hsmm_pair("gamma", learnable)
    n_param = sum(np.size(v) for v in _flat(nnx.state(jl, nnx.Param)).values())
    n_all = sum(np.size(v) for v in _flat(jl).values())
    info = tl.get_model_info()
    assert info["trainable_parameters"] == n_param
    assert info["total_parameters"] == n_all
    assert info["learnable_durations"] is learnable
    np.testing.assert_allclose(info["expected_durations"],
                               np.asarray(jl.get_expected_durations()), rtol=1e-6)
    if not learnable:
        with pytest.raises(ValueError):
            jl.get_model_info()


def test_duration_constrained_hmm_decode_matches_jax(obs):
    jm = JaxDC(S, F, min_duration=3, max_duration=6, hidden_dim=7, rngs=nnx.Rngs(1))
    tm = DurationConstrainedHMM(S, F, min_duration=3, max_duration=6, hidden_dim=7, device="cpu")
    tm.load_state_dict(bridge.hsmm_layer_state_dict(_flat(jm)))
    assert tm.duration_grid == 16
    np.testing.assert_array_equal(tm(torch.from_numpy(obs)).numpy(),
                                  np.asarray(jm(jnp.asarray(obs))))
    assert set(bridge.hsmm_layer_numpy(tm)) == set(_flat(jm))


# SemiMarkovHMM's unit-scale means put |alpha| at ~3e2 on this data,
# where f32 rounds at ~3e-5 a step and the two libraries' logsumexps
# round differently: posteriors agree within atol 5e-4, and the
# closed-form gradients and EM statistics built on them within 2e-3 of
# each tensor's largest entry.
SEMI_ATOL, SEMI_REL = 5e-4, 2e-3


def _rel_err(got, want):
    """Max difference over the finite entries relative to the largest of
    them; ``inf`` unless the infinite entries (the EM transition logits'
    -inf diagonal) match."""
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return float("inf")
    fin = np.isfinite(want)
    return float(np.abs(got[fin] - want[fin]).max() / max(np.abs(want[fin]).max(), 1e-30))


def _semi_pair(dist):
    """The two models, and observations drawn around the model's own
    means: SemiMarkovHMM initialises its means at unit scale, and data far
    from all of them leaves states with near-zero occupancy, where f32
    statistics of any two implementations part."""
    jm = JaxSemiMarkov(S, F, max_duration=D, duration_distribution=dist, rngs=nnx.Rngs(0))
    tm = SemiMarkovHMM(S, F, max_duration=D, duration_distribution=dist, device="cpu")
    tm.load_state_dict(bridge.semi_markov_state_dict(_flat(jm)))
    rng = np.random.default_rng(1)
    states = (np.arange(T)[None, :] // rng.integers(3, 9, size=(B, 1))) % S
    means = np.asarray(jm.observation_means[...])
    obs = (means[states] + rng.normal(size=(B, T, F))).astype(np.float32)
    return jm, tm, obs


@pytest.mark.parametrize("dist", ["gamma", "poisson", "gaussian", "neural"])
def test_semi_markov_matches_jax(dist):
    jm, tm, obs = _semi_pair(dist)
    jx, tx = jnp.asarray(obs), torch.from_numpy(obs)
    # Unsupervised forward: log Z and the forward tables.
    out_j, out_t = jm(jx), tm(tx)
    np.testing.assert_allclose(out_t["log_probability"].detach().numpy(),
                               np.asarray(out_j["log_probability"]), atol=1e-4)
    np.testing.assert_allclose(out_t["forward_variables"].numpy(),
                               np.asarray(out_j["forward_variables"]), atol=1e-4)
    # Supervised forward over a segmentation inside the duration grid.
    seg_s, seg_d = np.array([0, 2, 1, 3, 0]), np.array([8, 8, 8, 8, 8])
    sup_j = jm(jx[0], jnp.asarray(seg_s), jnp.asarray(seg_d))
    sup_t = tm(tx[0], torch.from_numpy(seg_s), torch.from_numpy(seg_d))
    for key in ("log_probability", "log_observation", "log_duration", "log_transition"):
        np.testing.assert_allclose(sup_t[key].detach().numpy(), np.asarray(sup_j[key]),
                                   atol=1e-4, err_msg=key)
    # Decode, (T, F) input run-length encoded and (B, T, F) batched.
    for x_j, x_t in ((jx[0], tx[0]), (jx, tx)):
        v_j, v_t = jm.viterbi_decode(x_j), tm.viterbi_decode(x_t)
        np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j[0]))
        if v_j[1] is not None:
            np.testing.assert_array_equal(v_t[1].numpy(), np.asarray(v_j[1]))
        np.testing.assert_allclose(v_t[2].numpy(), np.asarray(v_j[2]), rtol=1e-6)
    p_j, p_t = jm.posteriors(jx), tm.posteriors(tx)
    np.testing.assert_allclose(p_t["gamma"].numpy(), np.asarray(p_j["gamma"]), atol=SEMI_ATOL)
    # Gradients of the loss. The JAX model differentiates its forward scan
    # by autodiff; the port's loss takes the closed-form cotangents of
    # ops.auto_hsmm_log_z, whose f32 posteriors exp(alpha + beta - log Z)
    # sit ~5e-4 of the largest gradient off float64 here (autodiff ~3e-6).
    want_v, want_g = nnx.value_and_grad(lambda m: m.compute_loss(jx))(jm)
    loss = tm.compute_loss(tx)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_v), rtol=1e-6)
    want_t = bridge.semi_markov_state_dict(_flat(want_g))
    for name, p in tm.named_parameters():
        assert _rel_err(p.grad.numpy(), want_t[name].numpy()) <= SEMI_REL, name


@pytest.mark.parametrize("dist", ["gamma", "poisson", "gaussian"])
def test_semi_markov_em_step_matches_jax(dist):
    jm, tm, obs = _semi_pair(dist)
    want_ll, got_ll = jm.em_step(jnp.asarray(obs)), tm.em_step(torch.from_numpy(obs))
    np.testing.assert_allclose(got_ll.item(), float(want_ll), rtol=1e-6)
    after, want = bridge.semi_markov_numpy(tm), _flat(jm)
    for key, value in want.items():
        assert _rel_err(after[key], value) <= SEMI_REL, key


def test_adaptive_duration_contextual_log_likelihood_matches_jax(obs):
    kw = dict(context_dim=3, hidden_dim=6, max_duration=D)
    jm = JaxAdaptive(S, F, rngs=nnx.Rngs(2), **kw)
    tm = AdaptiveDurationHSMM(S, F, device="cpu", **kw)
    tm.load_state_dict(bridge.semi_markov_state_dict(_flat(jm)))
    ctx = np.random.default_rng(3).normal(size=(3,)).astype(np.float32)
    got = tm.contextual_log_likelihood(torch.from_numpy(obs), torch.from_numpy(ctx))
    want = jm.contextual_log_likelihood(jnp.asarray(obs), jnp.asarray(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    got.sum().backward()
    assert all(p.grad is not None for p in tm.context_duration_net.parameters())


def test_bridge_round_trips_nested_weights():
    jm = JaxAdaptive(S, F, context_dim=2, hidden_dim=5, max_duration=D,
                     duration_distribution="neural", rngs=nnx.Rngs(0))
    tm = AdaptiveDurationHSMM(S, F, context_dim=2, hidden_dim=5, max_duration=D,
                              duration_distribution="neural", device="cpu")
    tm.load_state_dict(bridge.semi_markov_state_dict(_flat(jm)))
    out = bridge.semi_markov_numpy(tm)
    assert set(out) == set(_flat(jm))
    for key, value in _flat(jm).items():
        np.testing.assert_array_equal(out[key], value)
    assert tm.context_duration_net[0].weight.shape == (5, 2 + S)
    with pytest.raises(KeyError):
        bridge.hsmm_layer_state_dict({"initial_logits": np.zeros(S)})


def test_sampling_keeps_the_segment_structure():
    """Structure only (the draws are torch's, not JAX's): no
    self-transitions between segments, durations in [min, max]."""
    layer = HSMMLayer(S, F, max_duration=6, min_duration=2, device="cpu")
    states, x = layer.generate_sequence(200, generator=torch.Generator().manual_seed(1))
    assert states.shape == (200,) and x.shape == (200, F)
    change = torch.nonzero(states[1:] != states[:-1]).flatten() + 1
    bounds = torch.cat([torch.tensor([0]), change, torch.tensor([200])])
    runs = (bounds[1:] - bounds[:-1])[1:-1]       # whole segments only
    assert runs.numel() > 0 and int(runs.min()) >= 2
    # A run may join two segments of one state only through a
    # self-transition, which the masked transitions forbid.
    assert int(runs.max()) <= 6
    model = SemiMarkovHMM(S, F, max_duration=7, min_duration=3, device="cpu")
    seg_s, seg_d, x = model.sample(12, max_length=60, generator=torch.Generator().manual_seed(4))
    assert bool((seg_s[1:] != seg_s[:-1]).all())
    full = seg_d[seg_d.cumsum(0) < 60]
    assert bool(((full >= 3) & (full <= 7)).all())
    assert x.shape == (int(seg_d.sum()), F) and int(seg_d.sum()) <= 60
    draws = model.duration_model.sample(torch.tensor([0, 1, 2]), 50,
                                        generator=torch.Generator().manual_seed(5))
    assert draws.shape == (3, 50) and int(draws.min()) >= 3 and int(draws.max()) <= 7


@pytest.mark.parametrize("lengths", [None, [60, 21, 1]])
def test_shifted_functions_equal_the_unshifted_plain_path(lengths):
    """``ops.pallas_hsmm_log_z`` / ``_pallas_hsmm_lz_masked`` (the
    kernel route's Functions, on max-shifted emissions) against
    ``core.hsmm_log_z`` on the raw ones, on the CPU, in float64 so the
    comparison sees the shift and not rounding: values and every
    gradient within 1e-9."""
    rng = np.random.default_rng(7)
    arrays = [30.0 * rng.normal(size=(3, 60, 5)) - 100.0, np.log(rng.dirichlet(np.ones(5), 5)),
              np.log(rng.dirichlet(np.ones(5))), np.log(rng.dirichlet(np.ones(9), 5))]
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)

    def run(fn):
        args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        val = fn(*args)
        (val * torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)).sum().backward()
        return val.detach(), [a.grad for a in args]

    shifted = (ops.pallas_hsmm_log_z if ln is None
               else lambda *a: ops._pallas_hsmm_lz_masked(*a, ln))
    got_v, got_g = run(shifted)
    want_v, want_g = run(lambda *a: core.hsmm_log_z(*a, ln))
    torch.testing.assert_close(got_v, want_v, atol=1e-9, rtol=1e-12)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, atol=1e-9, rtol=1e-9)


def test_duration_dispatch_routes_by_shape_before_any_work():
    """Off the CPU, shapes the kernels take go to them (meta tensors
    stand in for CUDA ones and are refused by the kernel wrapper before
    any work); S > 32 runs the plain ``core.hsmm`` on the tensors' own
    device, as the JAX package routes it."""
    meta = dict(device="meta")
    small = (torch.empty(2, 6, 4, **meta), torch.empty(4, 4, **meta), torch.empty(4, **meta),
             torch.empty(4, 3, **meta))
    for fn in (ops.auto_hsmm_viterbi, ops.auto_hsmm_log_z, ops.auto_hsmm_posteriors,
               ops.auto_hsmm_forward):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(*small)
    big = (torch.zeros(2, 6, 33, **meta), torch.zeros(33, 33, **meta), torch.zeros(33, **meta),
           torch.zeros(33, 3, **meta))
    states, score = ops.auto_hsmm_viterbi(*big)
    assert states.device.type == "meta" and states.shape == (2, 6)
    assert ops.auto_hsmm_log_z(*big).shape == (2,)


def test_refusals_name_their_roadmap_items(obs):
    _, tl = _hsmm_pair("gamma")
    before = {k: v.clone() for k, v in tl.state_dict().items()}
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tl.em_step(torch.from_numpy(obs), mesh=object())
    assert all(torch.equal(v, tl.state_dict()[k]) for k, v in before.items())
    # Neural emissions build; the reference's gaussian-only EM refuses them.
    neural = SemiMarkovHMM(S, F, observation_model="neural", device="cpu")
    with pytest.raises(NotImplementedError, match="gaussian emissions"):
        neural.em_step(torch.from_numpy(obs))
    with pytest.raises(ValueError, match="banana"):
        SemiMarkovHMM(S, F, observation_model="banana", device="cpu")
