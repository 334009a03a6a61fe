"""The program's own spans and counters (``repro_torch.utils.tracing``),
read in traced runs only.

The harness loads every probe in a traced run only, and reads each one's
``ENTRY`` as the window opens, while the traced run's kernel entry points
are wrapped (``trace.KernelCalls.install``). This probe counts nothing
from its entry point (``lpgf_force``, which builds the index and runs
before any window); reading its ``ENTRY`` attaches the program's tracing
to the run's recorder (``attach``):

- the program's tracing is enabled as the window opens, so nothing from
  set-up or warm-up is recorded, and disabled as it closes;
- wherever the recorder reads its gauges (the window's close, and the
  snapshot a tail-traced run takes as the profiler starts), the program's
  finished spans join ``Recorder.spans`` under their own names (seconds)
  and ``Recorder.marks`` (their bounds on the profiler's clock, so idle
  gaps on the device are named by the innermost span, the program's or
  the benchmark's), and the program's counters join the recorder's
  counters. A span that ends after the snapshot is in the marks but not
  in the snapshot's part, as the benchmark's own spans are;
- only the spans of the thread that runs the window become marks, since
  the idle attribution takes one thread's nested spans.

A program without ``repro_torch.utils.tracing`` is left as it is: no span
or counter of it is read, and the readers of these metrics return None.
Untraced runs never load this file, so they never enable the tracing."""
from __future__ import annotations

import sys
import threading
from typing import Optional


def __getattr__(name: str):
    if name == "ENTRY":
        rec = _recorder()
        if rec is not None and "program.spans" not in rec.gauges:
            attach(rec)
        return "lpgf_force"
    raise AttributeError(name)


def counts(a, out):
    return {}


def _recorder():
    """The recorder of the ``KernelCalls`` reading ``ENTRY``, if any."""
    from perfbench.trace import KernelCalls
    f = sys._getframe(1)
    while f is not None:
        calls = f.f_locals.get("self")
        if isinstance(calls, KernelCalls):
            return calls.rec
        f = f.f_back
    return None


class Reading:
    """The program's records moved into one recorder over its window."""

    def __init__(self, rec, tracing):
        self.rec = rec
        self.tracing = tracing
        self.tracer = tracing.enable()
        self.thread = threading.get_ident()
        self.next = 0          # spans[:next] looked at
        self.open = []         # indices below ``next`` still open then
        self.moved = 0

    def flush(self) -> int:
        """Move the finished spans not moved yet and the counters' totals
        into the recorder; returns the spans moved so far."""
        spans = self.tracer.spans
        end = len(spans)
        still = []
        for i in (*self.open, *range(self.next, end)):
            s = spans[i]
            if s is None:
                still.append(i)
                continue
            self.rec.spans[s.name].append((s.end_ns - s.start_ns) * 1e-9)
            if s.thread == self.thread:
                self.rec.marks.append((s.name, s.start_ns, s.end_ns))
            self.moved += 1
        self.open, self.next = still, end
        for name, value in list(self.tracer.counters.items()):
            self.rec.counters[name] = float(value)
        return self.moved

    def close(self) -> None:
        if self.tracing.current() is self.tracer:
            self.tracing.disable()


def attach(rec) -> Optional[Reading]:
    """Enable the program's tracing for ``rec``'s window (call as it
    opens, before its gauges' first reading); None where the program has
    no tracing of its own."""
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    reading = Reading(rec, tracing)
    rec.gauge("program.spans", reading.flush)
    rec.on_close.append(reading.close)
    return reading
