"""The program's own spans and counters in the benchmark
(``probes/program_tracing.py``): a traced run reads the six engine
metrics from them, idle gaps fall to the innermost span, the program's
or the benchmark's, only the window's part counts, and an untraced run
never enables the program's tracing."""
import bisect

import pytest

from perfbench import harness, spec
from perfbench.record import Recorder
from perfbench.tests import tiny
from perfbench.trace import _innermost

NEW = [("engine.masks_ms", "ms", "program_span"),
       ("engine.knn_ms", "ms", "program_span"),
       ("engine.rerank_ms", "ms", "program_span"),
       ("engine.walk_ms", "ms", "program_span"),
       ("engine.syncs", "syncs", "program_counter"),
       ("engine.readback_mb", "MB", "program_counter")]
OLD = {"planner.plan_ms", "engine.rows_per_query", "engine.rounds"}


@pytest.fixture
def traced_bench(tmp_path):
    """The tiny cells with the six metrics listed for the hybrid cell."""
    import torch
    torch.set_num_threads(1)
    path = tiny.write(str(tmp_path), per_layer=[
        tiny._metric(n, u, "lower", s, [tiny.HYBRID_CELL], "engine", "qps")
        for n, u, s in NEW])
    return path, [str(tmp_path), spec.PKG]


def _probe():
    return spec.load_module("probes", "program_tracing", [spec.PKG])


def test_the_repositorys_entries_have_readers():
    cell = spec.load("laion-b32-200k.hybrid")
    names = {m["name"]: m for m in cell.per_layer}
    for name, unit, source in NEW:
        m = names[name]
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == \
            (unit, source, "engine", "qps")
        assert m["better"] == "lower"
        assert callable(spec.load_module("metrics", name, [spec.PKG]).read)


@pytest.mark.parametrize("trace", [False, True])
def test_a_traced_run_reads_the_programs_spans(traced_bench, monkeypatch,
                                               trace):
    from repro_torch.utils import tracing
    enabled = []
    real = tracing.enable
    monkeypatch.setattr(tracing, "enable",
                        lambda: enabled.append(1) or real())
    path, dirs = traced_bench
    out, code = harness.run(tiny.HYBRID_CELL, 2 ** 31 + 13, 1.0, trace,
                            device="cpu", benchmark=path, dirs=dirs)
    assert code == 0 and out["correct"] is True
    assert tracing.current() is None
    if not trace:
        assert enabled == []      # untraced runs see only the off cost
        assert set(out["metrics"]) == {"qps", "setup_s"}
        return
    assert enabled == [1]
    assert set(out["metrics"]) == OLD | {n for n, _, _ in NEW}
    for m in out["metrics"].values():
        assert m["value"] > 0
    assert out["breakdown"]["idle_gaps"]


def test_a_program_without_tracing_leaves_the_metrics_out(
        traced_bench, monkeypatch):
    """The parent commit's program: no ``repro_torch.utils.tracing``."""
    import sys

    import repro_torch.utils
    monkeypatch.setitem(sys.modules, "repro_torch.utils.tracing", None)
    monkeypatch.delattr(repro_torch.utils, "tracing")
    path, dirs = traced_bench
    out, code = harness.run(tiny.HYBRID_CELL, 5, 1.0, True, device="cpu",
                            benchmark=path, dirs=dirs)
    assert code == 0 and out["correct"] is True
    assert set(out["metrics"]) == OLD


def test_reading_the_entry_elsewhere_enables_nothing():
    from repro_torch.utils import tracing
    assert _probe().ENTRY == "lpgf_force"
    assert tracing.current() is None


def test_idle_falls_to_the_innermost_program_span():
    """Synthetic spans: the benchmark's ``execute`` around the program's
    root and its stages; each gap is named by the span at its middle."""
    spans = [(0, 1000, "execute"), (10, 990, "planner.execute"),
             (20, 400, "engine.masks"), (30, 300, "engine.vr_eval"),
             (420, 430, "engine.upload"), (430, 600, "engine.fence"),
             (600, 900, "engine.rerank"), (1100, 1200, "plan"),
             (1110, 1190, "planner.plan")]
    times, labels = _innermost(spans)

    def at(t):
        return labels[bisect.bisect_right(times, t) - 1]
    assert at(5) == "execute" and at(995) == "execute"
    assert at(15) == "planner.execute" and at(950) == "planner.execute"
    assert at(200) == "engine.vr_eval" and at(350) == "engine.masks"
    assert at(500) == "engine.fence" and at(700) == "engine.rerank"
    assert at(1150) == "planner.plan" and at(1050) == "other"


def test_only_the_windows_part_counts():
    """Program spans from before the window (set-up, warm-up) never
    count; a span that ends after a tail trace's snapshot is in the
    marks but not in the part the readers read."""
    from repro_torch.utils import tracing
    rec = Recorder(trace=True)
    warm = tracing.enable()
    with tracing.span("engine.masks"):          # warm-up, before the window
        tracing.count("engine.syncs", 5)
    try:
        rec.on_open.append(lambda: _probe().attach(rec))
        rec.start_window()
        assert tracing.current() is not warm
        with rec.span("execute"):
            with tracing.span("planner.execute"):
                with tracing.span("engine.masks"):
                    tracing.count("engine.syncs", 2)
        rec.snapshot()
        with rec.span("execute"):
            with tracing.span("planner.execute"):
                with tracing.span("engine.masks"):
                    tracing.count("engine.syncs", 3)
        rec.end_window()
    finally:
        tracing.disable()
    _, counters, spans = rec.part()
    assert len(spans["engine.masks"]) == 1
    assert counters["engine.syncs"] == 2.0
    assert len(rec.spans["engine.masks"]) == 2     # the whole window
    assert rec.counters["engine.syncs"] == 5.0
    names = [m[0] for m in rec.marks]
    assert names.count("engine.masks") == 2 and names.count("execute") == 2
    marks = {m[0]: m for m in rec.marks}
    ex, root = marks["execute"], marks["planner.execute"]
    assert ex[1] <= root[1] and root[2] <= ex[2]


def test_spans_of_other_threads_are_not_marks():
    import threading

    from repro_torch.utils import tracing
    rec = Recorder(trace=True)
    try:
        rec.on_open.append(lambda: _probe().attach(rec))
        rec.start_window()
        with tracing.span("engine.walk"):
            pass

        def other():
            with tracing.span("engine.rerank"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        rec.end_window()
    finally:
        tracing.disable()
    assert set(rec.spans) == {"engine.walk", "engine.rerank"}
    assert [m[0] for m in rec.marks] == ["engine.walk"]
