"""Host time inside the program's certified re-rank a batch (ms): the
spans ``engine.rerank`` and ``engine.widen`` (the exact pass of jobs the
re-rank could not prove), over the window's batches; traced runs, from
``repro_torch.utils.tracing`` (``probes/program_tracing.py``)."""


def read(run):
    t, b = run.spans.get("engine.rerank"), run.counters.get("batches")
    if not t or not b:
        return None
    return (sum(t) + sum(run.spans.get("engine.widen", ()))) / b * 1e3
