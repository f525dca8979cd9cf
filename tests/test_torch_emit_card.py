"""Row 1's mixture mode (``csrc/diag_quadratic.cu`` with ``MIX``,
``ops.emit.diag_gmm_log_probs``) on the card: ``emissions.gmm_log_probs``
computing the GMM decode's state scores in one launch, held to the route
it replaces (row 1, then the plain logsumexp over components) and to the
plain version in float64.

The route it replaces shares row 1's sums and rounds each component
score as the kernel does, so the two differ only in the order of the
logsumexp's sum and in its ``exp`` and ``log``: within
``chip_smoke.MIX_ATOL`` at ``|score| <= chip_smoke.MIX_SCALE`` and in
proportion above. Against float64 the fused result may be off by no more
than the replaced route is, plus that tolerance. The cases are
``chip_smoke.MIX_CASES``: the ``gmm.decode.b4096`` cell's shape with
ragged lengths, two and five column tiles (N > 64), one tile with padded
columns.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_emit_card.py
"""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", [*chip_smoke.MIX_CASES, "cell tied"])
def test_card_mixture_kernel_matches_the_plain_version(case):
    dev = _card()
    cov = "tied" if case.endswith("tied") else "diag"
    shape = chip_smoke.MIX_CASES[case.split(" tied")[0]]
    gen = torch.Generator(device=dev).manual_seed(18)
    obs, means, cov_p, logits, _ = chip_smoke.mixture_problem(dev, gen, *shape, cov=cov)
    got, composite, want64, launches = chip_smoke.mixture_vs_plain(obs, means, cov_p, logits, cov)
    assert launches == (1, 1)
    assert got.shape == (*shape[:2], shape[2]) and got.dtype == torch.float32
    assert chip_smoke.mixture_share(got, composite) <= 1.0
    scale = max(1.0, want64.abs().max().item() / chip_smoke.MIX_SCALE)
    fused = (got.double() - want64).abs().max().item()
    plain = (composite.double() - want64).abs().max().item()
    assert fused <= plain + chip_smoke.MIX_ATOL * scale, (fused, plain)


@pytest.mark.card
def test_card_mixture_kernel_with_neg_inf_log_weights():
    """A state whose log mixture weights are all ``-inf``
    scores ``-inf`` on every frame, as the plain logsumexp gives (a
    non-finite max shifts by 0); a state with one ``-inf`` column scores
    from its other components. Held to the plain epilogue on row 1's own
    sums."""
    from pytorch_hmm_tpu_torch import emissions, ops
    from pytorch_hmm_tpu_torch.core.semiring import logsumexp

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(19)
    S, C = 12, 4
    obs, means, cov_p, logits, _ = chip_smoke.mixture_problem(dev, gen, 16, 300, S, C, 80)
    with torch.no_grad():
        wq, wl, bias, log_norm, log_w = emissions._diag_mixture_tables(means, cov_p, logits, "diag")
        log_w[3 * C:4 * C] = -math.inf
        log_w[5 * C + 1] = -math.inf
        before = ops.diag_quadratic.mixture_launches
        got = ops.emit.diag_gmm_log_probs(obs, wq, wl, bias, log_norm, log_w, C)
        assert ops.diag_quadratic.mixture_launches == before + 1
        comp = log_norm - 0.5 * ops.diag_quadratic(obs, wq, wl, bias) + log_w
        want = logsumexp(comp.reshape(*comp.shape[:-1], S, C), dim=-1)
    assert torch.isneginf(got[..., 3]).all() and torch.isneginf(want[..., 3]).all()
    others = [s for s in range(S) if s != 3]
    assert torch.isfinite(got[..., others]).all()
    assert chip_smoke.mixture_share(got, want) <= 1.0
