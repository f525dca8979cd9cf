"""Row 1, ``csrc/diag_quadratic.cu``: ``(x²) @ Wq + x @ Wl + b`` over the
valid frames. In: x, Wq, Wl, b; out: ``(frames, N)``. Operations: x², the
two products, the bias."""

PATTERN = r"\bdiag_quadratic_kernel\b"


def work(s):
    rows, d, n = s["frames"], s["D"], s["N"]
    return 4 * (rows * d + 2 * d * n + n + rows * n), rows * d + 4 * rows * d * n + rows * n
