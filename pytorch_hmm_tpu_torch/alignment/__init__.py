"""Alignment algorithms: CTC loss, forced alignment and decoding.

Port of the CTC half of ``pytorch_hmm_tpu/alignment``: lattice
recursions on the hand kernels of ``csrc/ctc_lattice.cu`` on the card,
plain torch elsewhere; batched greedy and prefix-beam decoding.
"""

from .ctc import (
    CTCAligner,
    CTCSegmentationAligner,
    collapse_repeated_tokens,
    ctc_alignment_path,
    ctc_backward_algorithm,
    ctc_decode_sequence,
    ctc_forward_algorithm,
    ctc_loss,
    ctc_viterbi_alignment,
    expand_targets_with_blank,
    remove_ctc_blanks,
)
from .ctc_decode import beam_search_decode_batch, greedy_decode_batch

__all__ = [
    "CTCAligner",
    "CTCSegmentationAligner",
    "ctc_alignment_path",
    "ctc_viterbi_alignment",
    "ctc_forward_algorithm",
    "ctc_backward_algorithm",
    "ctc_loss",
    "expand_targets_with_blank",
    "remove_ctc_blanks",
    "collapse_repeated_tokens",
    "ctc_decode_sequence",
    "greedy_decode_batch",
    "beam_search_decode_batch",
]
