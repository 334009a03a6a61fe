"""Host time inside the program's two walks of the host masks a batch
(ms): the spans ``engine.walk`` (into V.K jobs) and
``engine.finish_walk`` (substituting their rows), over the window's
batches; traced runs, from ``repro_torch.utils.tracing``
(``probes/program_tracing.py``)."""

SPANS = ("engine.walk", "engine.finish_walk")


def read(run):
    t = [x for name in SPANS for x in run.spans.get(name, ())]
    b = run.counters.get("batches")
    return sum(t) / b * 1e3 if t and b else None
