"""What one run records: the benchmark's own spans around its calls into
each layer, counters it reads from the program, and the window's bounds.
Spans and counters count only while the window is open. In a traced run
each span's bounds are also kept on the profiler's clock (the Unix
epoch in ns), so idle gaps on the device can be named by what the host
was doing. A run that traces only the window's tail takes a snapshot as
the profiler starts: its host-clock and program-counter metrics are read
over the part before it, which the profiler's cost does not slow."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


class Recorder:
    def __init__(self, trace: bool = False):
        self.trace = trace
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, float] = defaultdict(float)
        self.marks: List[tuple] = []   # traced: (span, start, end) in ns
        self.gauges: Dict[str, Tuple[Callable[[], float], float]] = {}
        self.host: Optional[tuple] = None   # the snapshot, see ``part``
        self.open = False
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.on_open = []      # callbacks run as the window opens,
        self.on_tick = []      # at each step of a loop inside it
        self.on_close = []     # and as it closes

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def gauge(self, name: str, read: Callable[[], float]) -> None:
        """A counter the program keeps: ``read()`` taken as the window
        opens and again as it closes (and at a snapshot), the difference
        counted. Register before the window opens."""
        self.gauges[name] = (read, 0.0)

    def _read_gauges(self) -> None:
        for name, (read, base) in self.gauges.items():
            self.counters[name] = float(read()) - base

    def start_window(self) -> float:
        for f in self.on_open:
            f()
        self.gauges = {n: (r, float(r())) for n, (r, _) in self.gauges.items()}
        self.open = True
        self.t0 = self.now()
        return self.t0

    def end_window(self) -> float:
        self.t1 = self.now()
        self._read_gauges()
        self.open = False
        for f in self.on_close:
            f()
        return self.t1

    def tick(self) -> None:
        """A loop's step inside the window (callbacks get its age, s)."""
        if self.open and self.on_tick:
            age = self.now() - self.t0
            for f in self.on_tick:
                f(age)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def snapshot(self) -> None:
        """Keep the window so far: its seconds, counters and spans."""
        self._read_gauges()
        self.host = (self.now() - self.t0, dict(self.counters),
                     {k: list(v) for k, v in self.spans.items()})

    def part(self) -> Tuple[float, Dict[str, float], Dict[str, List[float]]]:
        """(seconds, counters, spans) over the snapshot's part of the
        window, or over the whole window without one."""
        s, counters, spans = self.host or (
            self.window_s, dict(self.counters),
            {k: list(v) for k, v in self.spans.items()})
        return s, {k: float(v) for k, v in counters.items()}, spans

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a call on the host clock (and, traced, keep its bounds on
        the profiler's clock)."""
        t = self.now()
        ns = time.time_ns()
        try:
            yield
        finally:
            if self.open:
                self.spans[name].append(self.now() - t)
                if self.trace:
                    self.marks.append((name, ns, time.time_ns()))

    def count(self, name: str, value=1.0) -> None:
        """Add to a counter; a device tensor is added on the device and
        read once the window has closed."""
        if self.open:
            self.counters[name] = self.counters[name] + (
                value if hasattr(value, "device") else float(value))
