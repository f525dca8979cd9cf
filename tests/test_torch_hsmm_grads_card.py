"""Row 24, the training backward's cotangents (``csrc/hsmm_grads.cu``,
``ops.hsmm_table_grads``), against their plain version
``core.hsmm_grads_from_tables`` on the card, at ``chip_smoke.py``'s
shapes: the training cell's (B=1024, T=1000, S=10, D=20, lengths
250-1000), B=32, and the envelope's edges (S=1, S=32, D=1, D=256, T<D,
unragged, ragged with a length-1 row, ``g`` of mixed signs). Each case
runs the kernel twice and holds it bit for bit to itself, within
``chip_smoke.TABLE_GRADS_OBS_ATOL`` / ``TABLE_GRADS_RTOL`` of the plain
version (the reasons are beside those constants) and, against float64 on
the same tables, within ``TABLE_GRADS_F64`` times the plain version's own
error; it counts one launch a call.

The tests are marked ``card``: they need a CUDA card and skip elsewhere.
This file imports no JAX. On a card:

    python3 -m pytest --noconftest -o addopts= -m card tests/test_torch_hsmm_grads_card.py
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.mark.card
@pytest.mark.parametrize("case", list(chip_smoke.TABLE_GRADS_CASES))
def test_card_table_grads_match_the_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    errs, args = chip_smoke.check_table_grads(dev, torch.Generator(device=dev).manual_seed(14), case)
    assert set(errs) == {"d_log_obs", "d_log_a", "d_log_pi", "d_log_dur"}
    assert args[0].is_cuda
