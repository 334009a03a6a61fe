"""Host time inside the program's ``engine.masks`` span (the predicate
masks, the V.R route and their read-backs) a batch (ms), over the
window's batches; traced runs, from ``repro_torch.utils.tracing``
(``probes/program_tracing.py``)."""


def read(run):
    t, b = run.spans.get("engine.masks"), run.counters.get("batches")
    return sum(t) / b * 1e3 if t and b else None
