"""The neural HMM family of the torch port against its JAX twins, with
the same weights carried across by ``bridge``, on the same numpy inputs:
one counterpart of each case of tests/test_neural.py, held to values.

Both sides run f32 on the CPU. The JAX models take their XLA paths there
(its fused emission kernel is TPU-only); the port's eval-mode gaussian
head goes through ``fused_gaussian_emission``'s Function, whose CPU path
is the plain version the CUDA kernel is held to. Tolerances: transition
probabilities atol 1e-5; emission scores and posteriors atol 1e-4 (f32
products of up to H = 32 terms in another order; the JAX test's own
bound); Viterbi paths identical and scores within rtol 1e-6; likelihoods
rtol 1e-6; gradients rtol 1e-3 and atol 1e-4 of each tensor's largest
entry, at least 1e-6 (f32 sums over B·T frames in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pytorch_hmm_tpu import core as jcore
from pytorch_hmm_tpu.models import ContextualNeuralHMM as JaxContextual
from pytorch_hmm_tpu.models import NeuralHMM as JaxNeuralHMM
from pytorch_hmm_tpu.models import NeuralObservationModel as JaxObs
from pytorch_hmm_tpu.models import NeuralTransitionModel as JaxTrans
from pytorch_hmm_tpu.models.semi_markov import SemiMarkovHMM as JaxSemiMarkov
from pytorch_hmm_tpu_torch import (
    ContextualNeuralHMM,
    NeuralHMM,
    NeuralObservationModel,
    NeuralTransitionModel,
    SemiMarkovHMM,
    bridge,
    core,
)

S, D, C, H = 4, 6, 5, 32
B, T = 2, 18
POST = dict(atol=1e-4)


def _params(model) -> dict:
    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _grads(state, keys) -> dict:
    return {k: v for k, v in ((".".join(map(str, p)), np.asarray(v[...]))
                              for p, v in nnx.to_flat_state(state)) if k in keys}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    obs = rng.normal(size=(B, T, D)).astype(np.float32)
    ctx = rng.normal(size=(B, T, C)).astype(np.float32)
    return obs, ctx


def _close_grads(model, want: dict):
    for name, p in model.named_parameters():
        exp = want[name].numpy()
        scale = max(float(np.abs(exp).max()), 1e-12)
        got = np.zeros_like(exp) if p.grad is None else p.grad.numpy()   # unused: JAX's 0
        # An absolute floor of 1e-6 for gradients that are 0 in exact
        # arithmetic (attention key biases), where both sides hold noise.
        np.testing.assert_allclose(got, exp, rtol=1e-3, atol=max(1e-4 * scale, 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("mt", ["mlp", "rnn", "transformer"])
def test_neural_transitions_match_jax(data, mt):
    _, ctx = data
    jm = JaxTrans(S, C, hidden_dim=H, model_type=mt, rngs=nnx.Rngs(0)).eval()
    tm = NeuralTransitionModel(S, C, hidden_dim=H, model_type=mt, device="cpu").eval()
    tm.load_state_dict(bridge.neural_transition_state_dict(_params(jm)))
    assert set(bridge.neural_transition_numpy(tm)) == set(_params(jm))
    P = tm(torch.from_numpy(ctx))
    assert P.shape == (B, T, S, S)
    np.testing.assert_allclose(P.detach().numpy(), np.asarray(jm(jnp.asarray(ctx))), atol=1e-5)
    np.testing.assert_allclose(P.sum(-1).detach().numpy(), 1.0, atol=1e-5)
    # The single-step path, and a given current state.
    P1 = tm(torch.from_numpy(ctx[:, 0]))
    assert P1.shape == (B, S, S)
    np.testing.assert_allclose(P1.detach().numpy(), np.asarray(jm(jnp.asarray(ctx[:, 0]))),
                               atol=1e-5)
    cur = np.eye(S, dtype=np.float32)[np.arange(B) % S]
    np.testing.assert_allclose(
        tm(torch.from_numpy(ctx[:, 0]), torch.from_numpy(cur)).detach().numpy(),
        np.asarray(jm(jnp.asarray(ctx[:, 0]), jnp.asarray(cur))), atol=1e-5)


def test_neural_transition_unknown_type():
    with pytest.raises(ValueError, match="banana"):
        NeuralTransitionModel(4, 5, model_type="banana", device="cpu")


@pytest.mark.parametrize("ot", ["gaussian", "mixture", "autoregressive"])
def test_neural_observation_scores_match_jax(data, ot):
    obs, _ = data
    jm = JaxObs(S, D, hidden_dim=H, model_type=ot, rngs=nnx.Rngs(0)).eval()
    tm = NeuralObservationModel(S, D, hidden_dim=H, model_type=ot, device="cpu").eval()
    tm.load_state_dict(bridge.neural_observation_state_dict(_params(jm)))
    x = torch.from_numpy(obs)
    lp = tm(x)
    assert lp.shape == (B, T, S) and bool(torch.isfinite(lp).all())
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jm(jnp.asarray(obs))), **POST)
    idx = np.ones((B, T), np.int64)
    lp1 = tm(x, torch.from_numpy(idx))
    assert lp1.shape == (B, T)
    np.testing.assert_allclose(lp1.detach().numpy(),
                               np.asarray(jm(jnp.asarray(obs), jnp.asarray(idx))), **POST)
    if ot != "autoregressive":
        # Per-state scoring agrees with the all-state table.
        np.testing.assert_allclose(lp1.detach().numpy(), lp[..., 1].detach().numpy(), atol=1e-5)


def test_neural_observation_training_mode_matches_jax_without_dropout(data):
    """Training mode runs the plain products (no fused route); with
    dropout 0 both frameworks compute the same function."""
    obs, _ = data
    jm = JaxObs(S, D, hidden_dim=H, dropout=0.0, rngs=nnx.Rngs(2)).train()
    tm = NeuralObservationModel(S, D, hidden_dim=H, dropout=0.0, device="cpu").train()
    tm.load_state_dict(bridge.neural_observation_state_dict(_params(jm)))
    assert not tm._use_fused_emission()
    np.testing.assert_allclose(tm(torch.from_numpy(obs)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(obs))), **POST)


def test_dropout_draws_from_its_own_generator(data):
    """Masks come from the module's generator: training-mode features are
    reproducible for one seed and differ from eval mode; a mask drops
    about the requested share and scales the rest by ``1/(1 - rate)``, as
    ``nnx.Dropout`` does."""
    obs, _ = data
    x = torch.from_numpy(obs)

    def model(seed):
        return NeuralObservationModel(S, D, hidden_dim=H, dropout=0.3, device="cpu",
                                      generator=torch.Generator().manual_seed(seed)).train()

    m = model(3)
    a = m._trunk(x)
    assert torch.equal(a, model(3)._trunk(x))
    assert not torch.equal(a, m.eval()._trunk(x))
    out = m.train().drop(torch.ones(20_000))
    assert 0.28 < float((out == 0).float().mean()) < 0.32
    assert torch.allclose(out[out != 0], torch.tensor(1.0 / 0.7))


def test_neural_observation_sampling(data):
    obs, _ = data
    jm = JaxObs(S, D, hidden_dim=H, rngs=nnx.Rngs(0)).eval()
    tm = NeuralObservationModel(S, D, hidden_dim=H, device="cpu").eval()
    tm.load_state_dict(bridge.neural_observation_state_dict(_params(jm)))
    idx = np.arange(20).reshape(2, 10) % S
    s = tm.sample(torch.from_numpy(idx), generator=torch.Generator().manual_seed(5))
    assert s.shape == (2, 10, D)
    # The draw is the JAX model's mean and std around the generator's noise.
    emb = jm.state_embedding(jnp.asarray(idx))
    mean, std = jm.mean_net(emb), jnp.exp(0.5 * jm.logvar_net(emb))
    noise = torch.randn((2, 10, D), generator=torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(mean) + np.asarray(std) * noise,
                               atol=1e-5)
    for ot in ("mixture", "autoregressive"):
        with pytest.raises(NotImplementedError, match="gaussian head only"):
            NeuralObservationModel(S, D, hidden_dim=H, model_type=ot, device="cpu").sample(
                torch.zeros((1, 3), dtype=torch.long))


def test_unknown_observation_type():
    with pytest.raises(ValueError, match="banana"):
        NeuralObservationModel(4, 5, model_type="banana", device="cpu")


def _hmm_pair(context_dim, transition_type="mlp", **kw):
    jm = JaxNeuralHMM(S, D, context_dim=context_dim, hidden_dim=H,
                      transition_type=transition_type, rngs=nnx.Rngs(0), **kw)
    tm = NeuralHMM(S, D, context_dim=context_dim, hidden_dim=H,
                   transition_type=transition_type, device="cpu", **kw)
    tm.load_state_dict(bridge.neural_hmm_state_dict(_params(jm)))
    fj, fb = _params(jm), bridge.neural_hmm_numpy(tm)
    assert set(fj) == set(fb) and all(np.array_equal(fj[k], fb[k]) for k in fj)
    return jm, tm


def test_neural_hmm_static_matches_jax(data):
    """No context: an ordinary HMM on the neural emissions; posteriors,
    alpha and beta agree with the JAX model's and with ``core`` on its
    own emissions, in log space too."""
    obs, _ = data
    jm, tm = _hmm_pair(0)
    jm.eval(), tm.eval()
    x, jx = torch.from_numpy(obs), jnp.asarray(obs)
    got, want = tm(x), jm(jx)
    np.testing.assert_allclose(got[0].sum(-1).numpy(), 1.0, atol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POST)
    lo_t, la_t, lp_t = tm._dp_args(x, None, None)
    lo_j = jm.observation_model.log_probs(jx)
    np.testing.assert_allclose(lo_t.detach().numpy(), np.asarray(lo_j), **POST)
    w = jcore.forward_backward(lo_j, jax.nn.log_softmax(jm.transition_matrix[...], axis=-1),
                               jm._log_pi())
    g = core.forward_backward(lo_t.detach(), la_t.detach(), lp_t.detach())
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tt", ["mlp", "rnn", "transformer"])
def test_neural_hmm_dynamic_transitions_match_jax(data, tt):
    """Time-varying transitions: posteriors, Viterbi paths and scores,
    likelihoods and ``compute_loss`` gradients in eval mode (the port's
    emission Function against JAX's XLA path)."""
    obs, ctx = data
    jm, tm = _hmm_pair(C, tt)
    jm.eval(), tm.eval()
    x, c, jx, jc = torch.from_numpy(obs), torch.from_numpy(ctx), jnp.asarray(obs), jnp.asarray(ctx)
    la = tm._log_transitions(c)
    assert la.shape == (B, T, S, S)
    # The matrix computed at frame t-1 governs the step into t.
    raw = torch.log_softmax(tm.transition_model.transition_logits(c), -1)
    assert torch.equal(la[:, 1:], raw[:, :-1]) and torch.equal(la[:, 0], raw[:, 0])
    post, _, _ = tm(x, c)
    np.testing.assert_allclose(post.numpy(), np.asarray(jm(jx, jc)[0]), **POST)
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, atol=1e-4)
    st, sc = tm.viterbi_decode(x, c)
    sj, scj = jm.viterbi_decode(jx, jc)
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(sc.numpy(), np.asarray(scj), rtol=1e-6)
    ll = tm.compute_likelihood(x, c)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jm.compute_likelihood(jx, jc)),
                               rtol=1e-6)
    assert bool((ll >= sc - 1e-3).all())
    tm.compute_loss(x, c).backward()
    gj = nnx.grad(lambda m: m.compute_loss(jx, jc))(jm)
    _close_grads(tm, bridge.neural_hmm_state_dict(_grads(gj, _params(jm))))


def test_neural_hmm_training_mode_gradients_match_jax(data):
    """Training mode (plain emission products, dropout 0) with
    time-varying transitions: the loss and every gradient."""
    obs, ctx = data
    jm, tm = _hmm_pair(C, dropout=0.0)
    x, c, jx, jc = torch.from_numpy(obs), torch.from_numpy(ctx), jnp.asarray(obs), jnp.asarray(ctx)
    loss = tm.compute_loss(x, c)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jm.compute_loss(jx, jc)), rtol=1e-6)
    gj = nnx.grad(lambda m: m.compute_loss(jx, jc))(jm)
    _close_grads(tm, bridge.neural_hmm_state_dict(_grads(gj, _params(jm))))


def test_neural_hmm_refuses_a_mesh(data):
    obs, _ = data
    tm = NeuralHMM(S, D, hidden_dim=H, device="cpu")
    for call in (tm, tm.viterbi_decode, tm.compute_likelihood, tm.compute_loss):
        with pytest.raises(NotImplementedError, match="queue 1 item 12"):
            call(torch.from_numpy(obs), None, mesh=object())


def test_contextual_neural_hmm_matches_jax(data):
    obs, _ = data
    kw = dict(phoneme_vocab_size=11, linguistic_context_dim=8, prosody_dim=3, hidden_dim=H)
    jm = JaxContextual(S, D, rngs=nnx.Rngs(0), **kw).eval()
    tm = ContextualNeuralHMM(S, D, device="cpu", **kw).eval()
    tm.load_state_dict(bridge.neural_hmm_state_dict(_params(jm)))
    rng = np.random.default_rng(0)
    ph = rng.integers(0, 11, size=(B, T))
    pros = rng.normal(size=(B, T, 3)).astype(np.float32)
    ctx = tm.encode_context(torch.from_numpy(ph), torch.from_numpy(pros))
    assert ctx.shape == (B, T, 11)
    np.testing.assert_allclose(ctx.detach().numpy(),
                               np.asarray(jm.encode_context(jnp.asarray(ph), jnp.asarray(pros))),
                               atol=1e-6)
    got = tm.forward_with_context(torch.from_numpy(obs), torch.from_numpy(ph),
                                  torch.from_numpy(pros))
    want = jm.forward_with_context(jnp.asarray(obs), jnp.asarray(ph), jnp.asarray(pros))
    np.testing.assert_allclose(got[0].sum(-1).numpy(), 1.0, atol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **POST)


def test_semi_markov_neural_emissions_match_jax(data):
    """``SemiMarkovHMM(observation_model="neural")``: decode, likelihood
    and posteriors through the neural gaussian head; the EM and sampling
    refusals of the reference."""
    obs, _ = data
    kw = dict(max_duration=5, observation_model="neural")
    jm = JaxSemiMarkov(S, D, rngs=nnx.Rngs(0), **kw).eval()
    tm = SemiMarkovHMM(S, D, device="cpu", **kw).eval()
    tm.load_state_dict(bridge.semi_markov_state_dict(_params(jm)))
    assert set(bridge.semi_markov_numpy(tm)) == set(_params(jm))
    x, jx = torch.from_numpy(obs), jnp.asarray(obs)
    np.testing.assert_allclose(tm.observation_log_probs(x).detach().numpy(),
                               np.asarray(jm.observation_log_probs(jx)), **POST)
    path, _, score = tm.viterbi_decode(x)
    jpath, _, jscore = jm.viterbi_decode(jx)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-6)
    np.testing.assert_allclose(tm.log_likelihood(x).detach().numpy(),
                               np.asarray(jm.log_likelihood(jx)), rtol=1e-6)
    gamma = tm.posteriors(x)["gamma"]
    np.testing.assert_allclose(gamma.sum(-1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="gaussian emissions"):
        tm.em_step(x)
    with pytest.raises(NotImplementedError, match="gaussian observation model"):
        tm.sample(3)
