"""The traced run (``--trace 1``): ``torch.profiler`` over the window, the
program's kernel entry points observed, and the trace reduced to what
the per-layer readers and the result line need.

- Each kernel with a roofline law, ``laws/kernels/<kernel>.py``, names
  its entry point in ``repro_torch.kernels.ops`` (``ENTRY``), a substring
  of its device kernel's name (``SYMBOL``), its launch counter in
  ``repro_torch.kernels.<module>`` (``COUNTER``), the sizes of a call
  (``shape(arguments, out)``, None for a call that launches nothing) and
  the least time for them (``bound``). The entry point is wrapped, so
  each call is recorded with its sizes (the engine calls every kernel
  through that module's attributes); counts that depend on the data
  stay on the device until the window has closed.
- Each probe, ``probes/<name>.py``, names an entry point (``ENTRY``) and
  the counters it adds from a call (``counts(arguments, out)``).
- The kernels' own launch counters are reset as the profiler starts and
  must agree with the recorded calls and with the kernels the trace
  holds; a kernel whose counts disagree gets no roofline.
- Device busy time is the union of the device's activity intervals;
  idle gaps are named by the benchmark span (``plan``, ``execute``,
  ``embed``, ``poll`` ...) that covered them on the host. The profiler
  records the device's activity only, so the host loops it measures run
  at their own speed."""
from __future__ import annotations

import bisect
import functools
import importlib
import inspect
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch

from perfbench import spec


def _counter(law):
    module, attr = law.COUNTER
    return importlib.import_module("repro_torch.kernels." + module), attr


class KernelCalls:
    """Wrappers over the program's kernel entry points, recording calls
    (kernel laws) and counting what they return (probes)."""

    def __init__(self, rec, dirs: Sequence[str]):
        self.rec = rec
        self.laws = spec.found("laws/kernels", dirs)
        self.probes = spec.found("probes", dirs)
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self.seen: Dict[str, int] = defaultdict(int)   # calls on any device
        self.profiling = False     # shapes are recorded only while on
        self._saved = []

    def reset_launches(self) -> None:
        for law in self.laws.values():
            setattr(*_counter(law), 0)

    def install(self):
        from repro_torch.kernels import ops
        for name, law in self.laws.items():
            self._wrap(ops, law.ENTRY, self._recording(name, law))
        for probe in self.probes.values():
            self._wrap(ops, probe.ENTRY, self._counting(probe))

    def _wrap(self, ops, entry: str, make):
        real = getattr(ops, entry)
        self._saved.append((entry, real))
        setattr(ops, entry, make(real, inspect.signature(real)))

    def remove(self):
        from repro_torch.kernels import ops
        for entry, real in reversed(self._saved):
            setattr(ops, entry, real)
        self._saved = []

    def launches(self) -> Dict[str, int]:
        return {name: int(getattr(*_counter(law)))
                for name, law in self.laws.items()}

    @staticmethod
    def _arguments(sig, args, kwargs) -> dict:
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return bound.arguments

    def _recording(self, name: str, law):
        def make(real, sig):
            @functools.wraps(real)
            def call(*args, **kwargs):
                out = real(*args, **kwargs)
                self.seen[name] += 1
                if self.profiling:
                    shape = law.shape(self._arguments(sig, args, kwargs), out)
                    if shape is not None:
                        self.calls[name].append(tuple(shape))
                return out
            return call
        return make

    def _counting(self, probe):
        def make(real, sig):
            @functools.wraps(real)
            def call(*args, **kwargs):
                out = real(*args, **kwargs)
                for key, value in probe.counts(
                        self._arguments(sig, args, kwargs), out).items():
                    self.rec.count(key, value)
                return out
            return call
        return make

    def bounds(self) -> Dict[str, float]:
        """Seconds of bound by kernel, over the recorded calls."""
        out = {}
        for name, calls in self.calls.items():
            law = self.laws[name]
            out[name] = sum(
                law.bound(*(int(x) if torch.is_tensor(x) else x
                            for x in c))[0] for c in calls)
        return out


class Trace:
    """``torch.profiler`` over the window, or over its last ``trace_s``
    seconds where a whole window's trace would swamp the host loop it
    measures; the kernel entry points are observed over the whole
    window, their shapes recorded while the profiler runs."""

    def __init__(self, rec, device, seconds: float,
                 trace_s: Optional[float] = None,
                 dirs: Sequence[str] = (spec.PKG,)):
        self.rec = rec
        self.cuda = torch.device(device).type == "cuda"
        self.calls = KernelCalls(rec, dirs)
        self.prof = None
        self.begin_s = 0.0 if trace_s is None else max(0.0, seconds - trace_s)
        self.w0 = self.w1 = 0
        self.launches: Dict[str, int] = {}
        self.result: Optional[dict] = None
        rec.on_open.append(self.open)
        rec.on_tick.append(self.tick)
        rec.on_close.append(self.close)

    def open(self):
        self.calls.install()
        if self.begin_s == 0.0:
            self.start()

    def tick(self, elapsed: float):
        if self.prof is None and elapsed >= self.begin_s:
            self.start()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        if self.cuda:
            torch.cuda.synchronize()
        if self.begin_s > 0.0:
            self.rec.snapshot()
        self.calls.reset_launches()
        self.calls.profiling = True
        # the device's activity only: recording every host operation
        # would slow the host loops it measures; host spans come from
        # the recorder, on the same (Unix epoch) clock as the profiler's
        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            if self.cuda else [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.w0 = time.time_ns()

    def close(self):
        if self.prof is None:
            self.start()
        if self.cuda:
            torch.cuda.synchronize()
        self.w1 = time.time_ns()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.calls.profiling = False
        self.calls.remove()
        self.launches = self.calls.launches()
        print(f"trace: profiler stopped in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)

    def reduce(self) -> dict:
        """Busy seconds, kernel device time and event counts by kernel,
        the top device operations, and idle time by host span."""
        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
               for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        spans = [(a, b, name) for name, a, b in self.rec.marks
                 if b > self.w0]
        w0, w1 = self.w0, self.w1
        inside = sum(1 for a, b, _ in dev if w0 <= a and b <= w1)
        if dev and inside < len(dev):
            print(f"trace: {len(dev) - inside} of {len(dev)} device events "
                  f"outside the window", file=sys.stderr)
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
        by_name: Dict[str, float] = defaultdict(float)
        for a, b, n in dev:
            by_name[n] += (b - a) * 1e-9
        busy, gaps = _merge([(a, b) for a, b, _ in dev], w0, w1)
        idle = defaultdict(float)
        times, labels = _innermost(spans)
        for a, b in gaps:
            j = bisect.bisect_right(times, (a + b) / 2) - 1
            idle[labels[j] if j >= 0 else "other"] += (b - a) * 1e-9
        kernels = {}
        launches = self.launches
        bounds = self.calls.bounds()
        for name, law in self.calls.laws.items():
            evs = [(a, b) for a, b, n in dev if law.SYMBOL in n]
            recorded = len(self.calls.calls.get(name, ()))
            kernels[name] = dict(
                device_s=sum(b - a for a, b in evs) * 1e-9,
                events=len(evs), launches=launches[name],
                calls=recorded, bound_s=bounds.get(name, 0.0))
            if not (len(evs) == launches[name] == recorded):
                print(f"trace: {name}: {len(evs)} kernels in the trace, "
                      f"{launches[name]} launches counted, {recorded} calls "
                      f"recorded", file=sys.stderr)
        print(f"trace: kernel entry points called: {dict(self.calls.seen)}",
              file=sys.stderr)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.result = dict(
            busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9, kernels=kernels,
            device_ops=[[n[:160], s] for n, s in top],
            idle_gaps=sorted(([k, v] for k, v in idle.items()),
                             key=lambda kv: -kv[1])[:10])
        self.prof = None
        print(f"trace: {len(dev)} device events reduced in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        return self.result


def _innermost(spans):
    """The host's innermost span through time, as change points: (times,
    labels), labels[j] holding from times[j] on ("other" outside every
    span). Spans come from one thread's ``with`` blocks, so they nest."""
    times, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            labels.append(stack[-1][2] if stack else "other")
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        stack.append((a, b, name))
        times.append(a)
        labels.append(name)
    close_until(float("inf"))
    return times, labels


def _merge(intervals, w0: int, w1: int):
    """(total covered ns, the uncovered gaps) of ``intervals`` in
    [w0, w1]."""
    busy = 0
    gaps = []
    cur_a = cur_b = None
    last = w0
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                last = cur_b
            if a > last:
                gaps.append((last, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        last = cur_b
    if w1 > last:
        gaps.append((last, w1))
    return busy, gaps


def roofline_share(run, name: str):
    """A kernel's share of its roofline over the traced window (%), or
    None when the trace holds none of its launches or its counts
    disagree."""
    k = ((run.trace or {}).get("kernels") or {}).get(name)
    if not k or not k["events"] or \
            not k["events"] == k["launches"] == k["calls"]:
        return None
    return k["bound_s"] / k["device_s"] * 100.0
