"""Candidates rescored in fp32 per served request: the per-query rescue
counts ``ops.topk_l2_masked_mp`` returned in the window
(``probes/topk_l2_masked_mp.py``), summed, over the requests the server
served in it."""


def read(run):
    rescued, served = run.counters.get("rescued"), run.counters.get("served")
    return rescued / served if rescued is not None and served else None
