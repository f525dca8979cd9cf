"""Row 4 at general D, ``csrc/hsmm_smallk.cu``: the segment forward sum
chain. In: log-obs, log_a, log_pi, log_dur; out: alpha, log Z. Per frame
and state the predecessor logsumexp (add, exp, sum: 3 a predecessor) and
per duration the window sum, duration score, exp and sum."""

PATTERN = r"\bhsmm_forward_kernel\b"


def work(s):
    f, k, dm, b = s["frames"], s["K"], s["Dmax"], s["B"]
    return 4 * (f * k + k * k + k + k * dm + f * k + b), f * k * (3 * k + 4 * dm)
