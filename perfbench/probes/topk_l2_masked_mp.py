"""``ops.topk_l2_masked_mp``: the candidates its fp32 rescue rescored,
from the per-query counts it returns (summed on the device, read once
the window has closed), as the counter ``rescued``."""

ENTRY = "topk_l2_masked_mp"


def counts(a, out):
    return {"rescued": out[2].sum()}
