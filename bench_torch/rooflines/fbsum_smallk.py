"""Row 3, ``csrc/smallk_sum.cu``: both sum chains of the forward-backward
in one launch, in its time-varying mode (the only mode a cell runs). In:
the valid frames' log-obs and their ``K×K`` log transitions, log_pi, the
lengths; out: alpha and beta over the valid frames, log Z. Per frame and
state each chain adds, exponentiates and sums over the K predecessors (3
a predecessor)."""

PATTERN = r"\bfbsum_kernel\b"


def work(s):
    f, k, b = s["frames"], s["K"], s["B"]
    return 4 * (f * k + f * k * k + k + b + 2 * f * k + b), 2 * f * k * 3 * k
