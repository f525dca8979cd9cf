"""Row 6, the segment Viterbi (``csrc/hsmm_smallk.cu``,
``ops.hsmm_smallk_viterbi``), on the card: paths and scores bit-identical
to the plain ``core.hsmm.hsmm_viterbi`` on the same inputs, over the
layouts ``viterbi_plan`` gives (G = 32 // S lanes a state, from 32 at S=1
to 1 from S=17 on), durations from 1 to 256, ragged rows with a row of
one frame and rows shorter than D, uniform ties, and batches of 1, 32 and
4096 rows at T=300.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_hsmm_viterbi_card.py
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

T = 300
STATES = (1, 3, 8, 10, 16, 17, 32)
DURATIONS = (1, 2, 20, 33, 256)
# (B, S, D, ragged, min_duration): every (S, D) at B=32, ragged; every S at
# B=1 (D=20) and B=4096 (D=33, ragged); the bench's shape and the corners.
CASES = ([(32, s, d, True, 1) for s in STATES for d in DURATIONS]
         + [(1, s, 20, False, 1) for s in STATES]
         + [(4096, s, 33, True, 1) for s in STATES]
         + [(1, 32, 256, False, 1), (1, 1, 1, False, 1), (4096, 10, 20, True, 1),
            (4096, 10, 20, False, 3), (4096, 32, 256, True, 1), (4096, 3, 2, True, 1)])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _lengths(b, d, gen):
    """T, 1 and D - 1 (at least 1) first, the rest uniform over 1..T."""
    head = [T, 1, max(1, d - 1)][:b]
    rest = torch.randint(1, T + 1, (b - len(head),), generator=gen).tolist()
    return head + rest


def _check(dev, lo, la, lp, ld, ln):
    from pytorch_hmm_tpu_torch import core, ops

    states, score = ops.hsmm_smallk_viterbi(lo, la, lp, ld, ln)
    want_states, want_score = core.hsmm.hsmm_viterbi(lo, la, lp, ld, ln)
    assert states.dtype == torch.int32 and states.shape == lo.shape[:2]
    assert torch.equal(states, want_states), "paths differ"
    assert torch.equal(score, want_score), f"scores differ by {(score - want_score).abs().max().item()}"


@pytest.mark.card
@pytest.mark.parametrize("b,s,d,ragged,min_duration", CASES)
def test_card_viterbi_is_the_plain_trellis_bit_for_bit(b, s, d, ragged, min_duration):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(19_000 + 1000 * s + d + b)
    lengths = _lengths(b, d, torch.Generator().manual_seed(b + s + d)) if ragged else None
    _check(dev, *chip_smoke._hsmm_problem(dev, gen, b, T, s, d, lengths, min_duration))


@pytest.mark.card
@pytest.mark.parametrize("s,d,ragged", [(4, 6, False), (4, 6, True), (10, 20, False), (10, 20, True),
                                        (3, 2, True), (16, 33, False), (32, 33, True), (1, 20, False)])
def test_card_viterbi_breaks_ties_as_the_plain_trellis(s, d, ragged):
    """Uniform emissions, transitions and durations: every duration and
    every predecessor ties, across the lanes of a state too."""
    dev = _card()
    b, t = 3, 40
    a = torch.full((s, s), 1.0 / max(1, s - 1), device=dev)
    a.fill_diagonal_(1e-30)
    lo = torch.zeros((b, t, s), device=dev)
    lp = torch.full((s,), -torch.log(torch.tensor(float(s))).item(), device=dev)
    ld = torch.full((s, d), -torch.log(torch.tensor(float(d))).item(), device=dev)
    ln = torch.tensor([40, 13, 1], dtype=torch.int32, device=dev) if ragged else None
    _check(dev, lo, torch.log(a), lp, ld, ln)


@pytest.mark.card
def test_card_split_launches_count_the_plans_that_split_a_state():
    from pytorch_hmm_tpu_torch import ops
    from pytorch_hmm_tpu_torch.ops import hsmm_smallk

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(19)
    for s in STATES:
        args = chip_smoke._hsmm_problem(dev, gen, 4, 50, s, 20)
        before = (ops.hsmm_smallk_viterbi.launches, ops.hsmm_smallk_viterbi.split_launches)
        ops.hsmm_smallk_viterbi(*args)
        split = hsmm_smallk.viterbi_plan(s, 20).lanes > 1
        assert (ops.hsmm_smallk_viterbi.launches, ops.hsmm_smallk_viterbi.split_launches) == (
            before[0] + 1, before[1] + split)


@pytest.mark.card
def test_card_holds_a_wave_of_bench_chains_without_spilling():
    """At the bench's S=10, D=20 an SM holds 32 chains (4,224 on 132 SMs,
    one wave of B=4096); no layout spills, and the widest fits."""
    from pytorch_hmm_tpu_torch.ops import hsmm_smallk

    dev = _card()
    chains, regs, spilled = hsmm_smallk.viterbi_occupancy(10, 20, dev)
    assert chains == 32 and regs <= 64 and spilled == 0, (chains, regs, spilled)
    for s, d in ((1, 1), (3, 2), (16, 33), (17, 33), (32, 256)):
        chains, _, spilled = hsmm_smallk.viterbi_occupancy(s, d, dev)
        assert chains >= 1 and spilled == 0, (s, d, chains, spilled)
