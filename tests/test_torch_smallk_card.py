"""Row 2, the small-K Viterbi (``csrc/smallk_viterbi.cu``,
``ops.smallk_viterbi``), on the card: its bounded chain held to the plain
trellis in float64 at GMM scale and long T, and the GMM-HMM decode's
device ops under the port's spans.

The chain case is ``chip_smoke.VIT_LONG``: B=8, T=4096, K=12, features of
80 dims behind diagonal-Gaussian scores (~ -125 a frame for the true
state), lengths from 4096 down to 1024. Its scores must sit within
``chip_smoke.VIT_F64_RTOL`` of the float64 best plus
``chip_smoke.VIT_F64_ATOL_FRAME`` a frame (the reasons are beside those
constants): about 0.04 nats at |score| ~ 5e5, where a float32 chain on raw
scores drifts by nats. Each path must score within
``chip_smoke.VIT_PATH_GAP`` nats of the float64 best.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_smallk_card.py
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("ragged", [False, True])
def test_card_long_gmm_scale_chain_holds_float64(ragged):
    from pytorch_hmm_tpu_torch import core, ops

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(16)
    lo, la, lp, ln = chip_smoke.gmm_scale_problem(dev, gen, *chip_smoke.VIT_LONG)
    ln = ln if ragged else None
    before = ops.smallk_viterbi.launches
    states, score = ops.smallk_viterbi(lo, la, lp, ln)
    assert ops.smallk_viterbi.launches == before + 1
    _, best = core.viterbi(lo.double(), la.double(), lp.double(), ln)
    assert best.abs().min().item() > 1e5
    share = chip_smoke.score_share(best, score, lo.shape[1])
    assert share <= 1.0, f"scores off float64 by {share:.3g} of the tolerance"
    gap = chip_smoke._gap(best, chip_smoke.path_score64(lo, la, lp, states, ln)).max().item()
    assert gap <= chip_smoke.VIT_PATH_GAP, gap
    # The same launch again gives the same answer, bit for bit.
    again = ops.smallk_viterbi(lo, la, lp, ln)
    assert torch.equal(again[0], states) and torch.equal(again[1], score)


@pytest.mark.card
def test_card_gmm_decode_ops_lie_under_program_spans():
    """``MixtureGaussianHMMLayer(12, 80, num_components=4)`` decodes through
    ``forward`` -> ``auto_gmm_viterbi`` -> row 1 in its mixture mode (the
    logsumexp over components in its output stage) -> row 2, one launch of
    each kernel a call, every device op under a span of the port. Under
    ``ops.gmm_log_probs`` run only the weight tables' small ops, the same
    ones as the tables built alone, and row 1: no op of the plain
    logsumexp over the component scores is left."""
    from collections import Counter

    from bench_torch.spans import from_profile
    from pytorch_hmm_tpu_torch import MixtureGaussianHMMLayer, emissions, ops

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(17)
    layer = MixtureGaussianHMMLayer(12, 80, num_components=4, device=dev,
                                    generator=torch.Generator().manual_seed(3))
    obs = torch.randn((32, 1000, 80), device=dev, generator=gen)
    lengths = torch.linspace(1000, 250, 32, device=dev).round().to(torch.int32)
    layer(obs, lengths=lengths, return_log_probs=True)
    torch.cuda.synchronize(dev)
    counts = (ops.smallk_viterbi.launches, ops.diag_quadratic.launches,
              ops.diag_quadratic.mixture_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        layer(obs, lengths=lengths, return_log_probs=True)
        torch.cuda.synchronize(dev)
    assert (ops.smallk_viterbi.launches, ops.diag_quadratic.launches) == (counts[0] + 1,
                                                                          counts[1] + 1)
    assert ops.diag_quadratic.mixture_launches == counts[2] + 1
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad(), profile(activities=acts) as alone:
        log_w = torch.log_softmax(layer.mixture_weights_logits, dim=-1)
        torch.cuda.synchronize(dev)
        with torch.profiler.record_function("ops.tables"):
            emissions._diag_mixture_tables(layer.means, layer.cov_params, log_w, "diag")
        torch.cuda.synchronize(dev)
    d = from_profile(prof)
    assert d["ops"] and None not in d["op_span"]
    under = {d["spans"][i][0] for i in d["op_span"]}
    assert {"kernels.diag_quadratic", "kernels.smallk_viterbi"} <= under
    names = {x[0] for x in d["spans"]}
    assert {"models.gmm.decode", "models.gmm.transitions", "ops.auto_gmm_viterbi",
            "ops.gmm_log_probs", "kernels.smallk_viterbi"} <= names
    row2 = [d["ops"][k][0] for k, i in enumerate(d["op_span"])
            if d["spans"][i][0] == "kernels.smallk_viterbi"]
    assert sum("smallk_viterbi_kernel" in name for name in row2) == 1

    def under_span(trace, name):
        return Counter(trace["ops"][k][0] for k, i in enumerate(trace["op_span"])
                       if i is not None and trace["spans"][i][0] == name)

    row1 = under_span(d, "kernels.diag_quadratic")
    assert sum(row1.values()) == 1 and all("diag_quadratic_kernel" in n for n in row1)
    tables = under_span(from_profile(alone), "ops.tables")
    assert tables and under_span(d, "ops.gmm_log_probs") == tables
