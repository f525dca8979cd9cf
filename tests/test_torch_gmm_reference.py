"""The benchmark's plain GMM-HMM reference (``bench_torch/reference/gmm_hmm.py``)
against the port's ``MixtureGaussianHMMLayer`` decode, and the GMM family's
pool and reference as functions of the seed.

The port runs its CPU path here (row 1's and row 2's plain versions in
float32); the reference runs in float64 on the same weights and features.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness  # noqa: E402
from bench_torch.families import gmm_hmm  # noqa: E402
from bench_torch.reference import gmm_hmm as ref  # noqa: E402
from bench_torch.reference.tf32 import exact_matmul, tf32_matmul  # noqa: E402

CFG = {"num_states": 12, "num_components": 4, "feature_dim": 8, "covariance_type": "diag",
       "learnable_transitions": True, "walk_max_dwell": 20}
TRAFFIC = {"batch": 3, "min_frames": 20, "max_frames": 60, "pool": 2}
SEED = 2**31 + 16
# The port's float32 CPU path against float64: the emissions (8 features,
# 4 components) and a 60-frame chain round at ~1e-7 of a score of a few
# hundred nats; 1e-5 relative leaves that a hundredfold.
SCORE_RTOL = 1e-5


def _pool(seed, traffic=TRAFFIC):
    gen = torch.Generator().manual_seed(seed)
    w = gmm_hmm.weights(CFG, gen, torch.device("cpu"))
    return w, harness.Pool(gmm_hmm, CFG, traffic, w, gen, torch.device("cpu"))


def _problem(dtype=torch.float64, matmul=exact_matmul, seed=SEED):
    w, pool = _pool(seed)
    obs, lengths = pool.batch(0)
    return w, obs, lengths, gmm_hmm.reference_problem(CFG, w, obs, dtype, matmul)


def test_port_decode_matches_the_reference():
    w, obs, lengths, problem = _problem()
    assert lengths.tolist()[0] == 60 and min(lengths.tolist()) < 60
    model = gmm_hmm.program(CFG, w, torch.device("cpu"))
    states, score = gmm_hmm.program_decode(model, obs, lengths)
    best, path = gmm_hmm.reference_viterbi(problem, lengths)
    assert torch.equal(states.long(), path)
    torch.testing.assert_close(score.double(), best, rtol=SCORE_RTOL, atol=0)
    # The port's emissions and transitions are the reference's.
    torch.testing.assert_close(model.get_observation_log_probs(obs).double(), problem[0],
                               rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(model._log_a().double(), problem[1], rtol=1e-6, atol=1e-6)
    # The reference scores its own path at its best, and no other above it.
    torch.testing.assert_close(gmm_hmm.reference_path_score(problem, path, lengths), best,
                               rtol=1e-12, atol=1e-9)
    other = path.clone()
    other[0, 5] = (other[0, 5] + 1) % CFG["num_states"]
    assert gmm_hmm.reference_path_score(problem, other, lengths)[0] < best[0]


def test_reference_in_float64_matches_a_plain_loop():
    """The reference's emissions and trellis written out a frame and a
    component at a time."""
    w, obs, lengths, (lo, la, lp) = _problem()
    x = obs.double()
    means, lv = w["means"].double(), w["cov_params"].double()
    log_w = torch.log_softmax(w["mixture_weights_logits"].double(), -1)
    diff = x[:, :, None, None, :] - means                            # (B, T, S, C, D)
    comp = -0.5 * (CFG["feature_dim"] * math.log(2 * math.pi) + lv.sum(-1)
                   + (diff * diff * torch.exp(-lv)).sum(-1))
    torch.testing.assert_close(lo, torch.logsumexp(comp + log_w, -1), rtol=1e-12, atol=1e-10)
    for b, n in enumerate(lengths.tolist()):
        delta = lp + lo[b, 0]
        for t in range(1, n):
            delta = (delta[:, None] + la).max(0).values + lo[b, t]
        best, _ = ref.viterbi(lo[b:b + 1], la, lp, lengths[b:b + 1])
        torch.testing.assert_close(best[0], delta.max(), rtol=1e-12, atol=0)


def test_pool_and_reference_are_the_seeds():
    (w1, a), (w2, b), (_, c) = _pool(SEED), _pool(SEED), _pool(SEED + 1)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert torch.equal(a.obs, b.obs) and torch.equal(a.lengths, b.lengths)
    assert not torch.equal(a.obs, c.obs)
    assert sorted(sum(a.lens, [])) == sorted(sum(c.lens, []))
    valid = torch.arange(TRAFFIC["max_frames"])[None, None] < a.lengths[..., None]
    assert torch.all(a.obs[~valid] == 0) and torch.all(a.obs[valid].abs().sum(-1) > 0)
    (_, _, lengths, p1), (_, _, _, p2) = _problem(), _problem()
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    s1, path1 = gmm_hmm.reference_viterbi(p1, lengths)
    s2, path2 = gmm_hmm.reference_viterbi(p2, lengths)
    assert torch.equal(s1, s2) and torch.equal(path1, path2)


def test_features_follow_their_states():
    """At the configuration's 80 features each frame scores best under the
    state that drew it, ~125 nats below zero: the scale the decode cells
    run at."""
    from bench_torch.families import walks

    cfg, traffic, dev = dict(CFG, feature_dim=80), dict(TRAFFIC, batch=4, max_frames=200), "cpu"
    gen = torch.Generator().manual_seed(SEED)
    w = gmm_hmm.weights(cfg, gen, dev)
    lengths = walks.lengths(traffic, gen, dev)
    states = gmm_hmm.frame_states(cfg, traffic, lengths, gen, dev)
    lo = ref.log_obs(gmm_hmm.observations(w, states, gen)[0], w, torch.float64)
    best = lo.max(-1).values
    assert (lo.argmax(-1) == states[0]).double().mean().item() > 0.99
    assert -140 < best.mean().item() < -110


@pytest.mark.parametrize("blocks", [1, 7])
def test_reference_blocks_do_not_change_the_scores(monkeypatch, blocks):
    w, obs, _, (lo, _, _) = _problem()
    monkeypatch.setattr(ref, "BLOCK_ROWS", blocks)
    torch.testing.assert_close(ref.log_obs(obs, w, torch.float64), lo, rtol=0, atol=1e-12)


def test_the_control_is_off_by_more_than_float64():
    """TF32 products move the control's scores by far more than float64
    rounding: the control the output check must refuse is not the judge."""
    _, _, lengths, p64 = _problem()
    _, _, _, p32 = _problem(torch.float32, tf32_matmul)
    best64, _ = gmm_hmm.reference_viterbi(p64, lengths, path=False)
    best32, _ = gmm_hmm.reference_viterbi(p32, lengths, path=False)
    err = ((best32.double() - best64).abs() / best64.abs()).max().item()
    assert err > 1e-5, err


def test_counts_by_hand():
    """Row 2's roofline work and the family's operations a frame, worked
    by hand at a tiny size."""
    roof = harness._load_file(Path(harness.HERE) / "rooflines" / "smallk_viterbi.py", "k_smallk")
    s = {"B": 2, "frames": 10, "D": 3, "N": 8, "K": 4}
    # log-obs 40, log_a 16, log_pi 4 in; states 10, scores 2 out: 4 (40 + 16 + 4 + 10 + 2)
    # bytes. An add and a compare per predecessor: 10 frames x 4 states x 8.
    assert roof.work(s) == (288, 320)
    assert harness.metric_reader("smallk_viterbi_roofline") is not None
    cfg = dict(CFG, num_states=2, num_components=3, feature_dim=4)
    # x² 4; per component the two products 16 and 3 more; the mixture 4 a
    # component; the trellis 2 a predecessor and state.
    assert gmm_hmm.flops_per_frame(cfg, "decode") == 4 + 6 * 19 + 4 * 6 + 2 * 4
    with pytest.raises(ValueError):
        gmm_hmm.flops_per_frame(cfg, "train")
    assert gmm_hmm.shapes(CFG, [3, 5]) == {"B": 2, "frames": 8, "D": 8, "N": 48, "K": 12}
