"""Row 5 at general D, ``csrc/hsmm_smallk.cu``: the segment backward sum
chain. In: log-obs, log_a, log_dur; out: beta*, beta_start. Operations as
row 4."""

PATTERN = r"\bhsmm_backward_kernel\b"


def work(s):
    f, k, dm = s["frames"], s["K"], s["Dmax"]
    return 4 * (f * k + k * k + k * dm + 2 * f * k), f * k * (3 * k + 4 * dm)
