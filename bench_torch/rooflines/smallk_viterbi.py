"""Row 2, ``csrc/smallk_viterbi.cu``: the small-K Viterbi with its
backtrace. In: log-obs over the valid frames, log_a, log_pi; out: the
states of the valid frames, the scores. Per frame and state an add and a
compare per predecessor. The backpointers, written and read back inside
the launch, are the kernel's own and are not counted."""

PATTERN = r"\bsmallk_viterbi_kernel\b"


def work(s):
    f, k, b = s["frames"], s["K"], s["B"]
    return 4 * (f * k + k * k + k + f + b), f * k * 2 * k
