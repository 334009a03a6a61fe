"""Requests per executed micro-batch: the server's ``served`` over its
``batches`` counter, both taken over the window."""


def read(run):
    c = run.counters.get("chunks")
    return run.counters["served"] / c if c else None
