"""Host time inside the program's KNN stages a batch (ms): the spans
``engine.upload``, ``engine.dispatch``, ``engine.fence``,
``engine.stragglers`` and ``engine.readback`` of every KNN group, over
the window's batches; traced runs, from ``repro_torch.utils.tracing``
(``probes/program_tracing.py``)."""

SPANS = ("engine.upload", "engine.dispatch", "engine.fence",
         "engine.stragglers", "engine.readback")


def read(run):
    t = [x for name in SPANS for x in run.spans.get(name, ())]
    b = run.counters.get("batches")
    return sum(t) / b * 1e3 if t and b else None
