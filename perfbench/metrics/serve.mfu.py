"""The embedder's share of the H100's bf16 peak while it runs (%): the
forward's operations (``laws/embedder.py``, from each call's batch and
prompt length) over the host time inside ``EmbeddingServer.embed``
(each call ends in the read-back of its result), over 989 TFLOP/s. At a
fixed offered rate a share of the window would read the load; this
reads how well each step uses the card."""
from perfbench.laws.roofline import PEAK_OPS


def read(run):
    f, t = run.counters.get("embed_flops"), run.spans.get("embed")
    return f / sum(t) / PEAK_OPS["bf16"] * 100.0 if f and t else None
