"""Bytes the engine read back from the device a batch (MB, 1e6 bytes),
into pageable or pinned memory: the program's counter
``engine.readback_bytes`` over the window's batches; traced runs, from
``repro_torch.utils.tracing`` (``probes/program_tracing.py``)."""


def read(run):
    n = run.counters.get("engine.readback_bytes")
    b = run.counters.get("batches")
    return n / 1e6 / b if n is not None and b else None
