"""Times a batch the engine's host waited on the device: the program's
counter ``engine.syncs`` (each read-back into host memory, scalar read
and event synchronise of the hybrid path) over the window's batches;
traced runs, from ``repro_torch.utils.tracing``
(``probes/program_tracing.py``)."""


def read(run):
    n, b = run.counters.get("engine.syncs"), run.counters.get("batches")
    return n / b if n is not None and b else None
