"""Beam rounds per batch: ``EngineStats.knn_rounds`` over the window's
batches."""


def read(run):
    b = run.counters.get("batches")
    return run.counters["knn_rounds"] / b if b else None
