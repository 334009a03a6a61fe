"""``ops.topk_l2_masked``: G queries, each over its own C fp32
candidates of width D, the k nearest valid ones out. ``needed``
candidates must be read in full: the valid ones, less those whose lower
bound (when ``lb2`` is given) lies above the k-th distance. The validity
byte (and bound) of every candidate, the queries and the (distance, id)
outputs are read or written once."""
from perfbench.laws.roofline import bound_s

ENTRY = "topk_l2_masked"
SYMBOL = "topk_l2_masked_kernel"
COUNTER = ("fused_topk", "topk_l2_masked_launches")


def shape(a, out):
    """The sizes, with the needed count left on the device (read once
    the window has closed)."""
    q, p, valid, k, lb2 = a["q"], a["p"], a["valid"], a["k"], a["lb2"]
    g, c, dim = p.shape
    if not (q.is_cuda and g and c):
        return None
    d = out[0]
    kth = d[:, min(k, c) - 1:min(k, c)]
    need = valid.bool() if lb2 is None else \
        valid.bool() & (lb2.float() <= kth)
    return g, c, dim, k, need.sum(), lb2 is not None


def bound(g: int, c: int, d: int, k: int, needed: int, lb2: bool):
    return bound_s(2.0 * needed * d,
                   4.0 * needed * d + g * c * (5.0 if lb2 else 1.0)
                   + 4.0 * g * d + 12.0 * g * k)
