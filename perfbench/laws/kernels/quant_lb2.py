"""``ops.quant_lb2``: G queries over C int8 or bf16 candidate codes of
width D: each valid candidate's codes and 12 bytes of metadata (scale,
norm, error), every candidate's validity byte and fp32 output, the
quantized queries and their 16 bytes of metadata."""
from perfbench.laws.roofline import bound_s

ENTRY = "quant_lb2"
SYMBOL = "quant_lb2_kernel"
COUNTER = ("quant_lb2", "launches")


def shape(a, out):
    g, c, dim = a["codes"].shape
    if not (a["q"].is_cuda and g and c):
        return None
    return g, c, dim, a["valid"].bool().sum(), a["precision"]


def bound(g: int, c: int, d: int, nvalid: int, precision: str):
    esz = 1 if precision == "int8" else 2
    return bound_s(2.0 * nvalid * d,
                   esz * (nvalid * d + g * d) + 12.0 * nvalid + 5.0 * g * c
                   + 16.0 * g, "int8" if precision == "int8" else "bf16")
