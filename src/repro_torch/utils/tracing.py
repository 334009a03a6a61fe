"""The program's own spans and counters, off by default.

While tracing is off, ``span(name)`` hands back one shared object whose
``with`` does nothing (no allocation, no clock read) and ``count`` returns
at once. ``enable()`` starts a ``Tracer`` that keeps, in memory only:

- spans: one record per ``with span(name)`` block, in the order the
  blocks were entered, ``Span(name, start_ns, end_ns, parent, batch,
  thread)`` on ``time.time_ns()`` (the Unix epoch in ns, the clock of
  ``torch.profiler``'s device events). ``parent`` is the index of the
  enclosing span on the same thread (-1 for none) and ``batch`` the index
  of the outermost one, so every span of one batch shares it. A block
  still open holds None in its slot.
- counters: totals by name, added to by ``count(name, value)``.

Nothing is written anywhere: whoever enabled the tracer reads its
records, and ``disable()`` ends recording. A span entered while off stays
a no-op if tracing turns on before it exits.

Spans of the batched hybrid path (``core/planner.py``, ``core/engine.py``):

- ``planner.plan``: ``Session.plan``, normalising, signing and the plan
  cache; a root of its own.
- ``planner.execute``: ``ExecutablePlan.execute``, the root of a batch.
  Inside it ``planner.record``: the QBS and cost-model records after the
  engine returns (two blocks a batch).
- ``engine.masks``: the predicate masks, with their read-backs; inside it,
  per V.R group, ``engine.vr_route`` (the tile bound, its read-back and
  the route's choice), ``engine.vr_eval`` (the dense or tile distance
  pass and its read-back) and ``engine.vr_recheck`` (the host's exact
  test of rows near the radius and the mask's assembly).
- ``engine.walk``: the planning walk of the masks into V.K jobs.
- per KNN group: ``engine.upload`` (queries and masks stacked and sent
  up), ``engine.dispatch`` (the beam loop's prologue and first round
  enqueued, or the whole loop where it runs on the host),
  ``engine.fence`` (the host waiting for the first round),
  ``engine.stragglers`` (the straggler rounds), ``engine.readback``
  (their results and the left-out rows' bounds brought back),
  ``engine.rerank`` (the certified re-rank on the host) and
  ``engine.widen`` (the exact pass of jobs the re-rank could not prove).
- ``engine.finish_walk``: the finishing walk that substitutes the jobs'
  rows.

Counters: ``engine.syncs``, each time the engine's host waits on the
device (a read-back into host memory, a scalar read, an event's
synchronise); ``engine.readback_bytes``, the bytes its read-backs copy
from the device, pageable or pinned.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    batch: int
    thread: int


class Tracer:
    """The records of one enabled stretch (see the module's docstring)."""

    def __init__(self):
        self.spans: List[Optional[Span]] = []
        self.counters: Dict[str, float] = defaultdict(int)
        self._lock = threading.Lock()
        self._stack = threading.local()   # per thread: [(index, batch)]

    def _open(self) -> tuple:
        stack = getattr(self._stack, "s", None)
        if stack is None:
            stack = self._stack.s = []
        with self._lock:
            i = len(self.spans)
            self.spans.append(None)
        parent, batch = stack[-1] if stack else (-1, i)
        stack.append((i, batch))
        return i, parent, batch

    def _close(self, i: int, record: Span) -> None:
        self.spans[i] = record
        self._stack.s.pop()

    def add(self, name: str, value) -> None:
        with self._lock:
            self.counters[name] += value


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_tracer: Optional[Tracer] = None


class _On:
    __slots__ = ("tracer", "name", "i", "parent", "batch", "start")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.i, self.parent, self.batch = self.tracer._open()
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        self.tracer._close(self.i, Span(
            self.name, self.start, end, self.parent, self.batch,
            threading.get_ident()))
        return False


def span(name: str):
    """A ``with`` block recorded as the span ``name`` while tracing is
    on."""
    t = _tracer
    if t is None:
        return _OFF
    return _On(t, name)


def count(name: str, value=1) -> None:
    """Add ``value`` to the counter ``name`` while tracing is on."""
    t = _tracer
    if t is not None:
        t.add(name, value)


def enable() -> Tracer:
    """Start recording into a new ``Tracer`` and return it."""
    global _tracer
    _tracer = Tracer()
    return _tracer


def disable() -> None:
    """Stop recording."""
    global _tracer
    _tracer = None


def current() -> Optional[Tracer]:
    """The tracer recording now, or None while tracing is off."""
    return _tracer
