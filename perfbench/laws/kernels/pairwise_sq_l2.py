"""``ops.pairwise_sq_l2``: (M, D) x (N, D) fp32 -> (M, N) squared
distances."""
from perfbench.laws.roofline import bound_s

ENTRY = "pairwise_sq_l2"
SYMBOL = "pairwise_sq_l2_kernel"
COUNTER = ("pairwise_l2", "launches")


def shape(a, out):
    q, p = a["q"], a["p"]
    if q.is_cuda and q.shape[0] and p.shape[0]:
        return q.shape[0], p.shape[0], q.shape[1]
    return None


def bound(m: int, n: int, d: int):
    return bound_s(2.0 * m * n * d, 4.0 * (m * d + n * d + m * n))
