"""Row 24, ``csrc/hsmm_grads.cu``: the training backward's cotangents of
log Z from the sum chains' tables. In: log-obs, alpha, beta* and
beta_start, each read once over the valid frames; log_a, log_pi, log_dur,
log Z and g. Out: d log-obs over the valid frames, written once, and the
parameters' cotangents. Per frame and state the entry logsumexp and the
transition terms (4 a predecessor), the duration terms (6 a duration: the
window sum, four adds and the exp with its sum) and start, end and the
occupancy (6). The pattern names the main launch; the fixed-order reduce
that follows it (``hsmm_table_grads_reduce_kernel``, a few microseconds)
is left out of the time."""

PATTERN = r"\bhsmm_table_grads_kernel\b"


def work(s):
    f, k, dm, b = s["frames"], s["K"], s["Dmax"], s["B"]
    return 4 * (5 * f * k + 2 * (k * k + k + k * dm) + 2 * b), f * k * (4 * k + 6 * dm + 6)
