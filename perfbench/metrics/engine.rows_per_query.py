"""Rows the beam rounds fed to the top-k kernel per query:
``EngineStats.rows_scanned`` over ``EngineStats.queries``, summed over
the window's batches."""


def read(run):
    q = run.counters.get("queries")
    return run.counters["rows_scanned"] / q if q else None
