"""Row 6, ``csrc/hsmm_smallk.cu``: the segment Viterbi with its
backtrace. In: log-obs, log_a, log_pi, log_dur; out: states, score. Per
frame and state an add and a compare per predecessor, and per duration
the window sum, the duration score and the compare."""

PATTERN = r"\bhsmm_viterbi_kernel\b"


def work(s):
    f, k, dm, b = s["frames"], s["K"], s["Dmax"], s["B"]
    return 4 * (f * k + k * k + k + k * dm + f + b), f * k * (2 * k + 3 * dm)
