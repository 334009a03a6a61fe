"""The port's own spans and counters (``repro_torch.utils.tracing``) over
the batched hybrid path, on a small CPU platform whose batch holds the
four archetypes: off, nothing is recorded; on, every stage's span nests
under its named parent with one batch id, the counters repeat, and rows
and ``EngineStats`` are those of an untraced run."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import query as TQ
from repro_torch.core.lake import MMOTable as TTable
from repro_torch.core.platform import MQRLD
from repro_torch.utils import tracing

torch.set_num_threads(1)

N, D, BATCH = 2400, 8, 24

# every span of the hybrid path but ``engine.widen`` (only a job whose
# re-rank is not proven takes it), with its parent
PARENT = {
    "planner.execute": None,
    "engine.masks": "planner.execute",
    "engine.vr_route": "engine.masks",
    "engine.vr_eval": "engine.masks",
    "engine.vr_recheck": "engine.masks",
    "engine.walk": "planner.execute",
    "engine.upload": "planner.execute",
    "engine.dispatch": "planner.execute",
    "engine.fence": "planner.execute",
    "engine.stragglers": "planner.execute",
    "engine.readback": "planner.execute",
    "engine.rerank": "planner.execute",
    "engine.finish_walk": "planner.execute",
    "planner.record": "planner.execute",
}


def _table(shift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D)).astype(np.float32) * 6
    cat = rng.integers(0, 12, N)
    vec = (centers[cat] + rng.normal(size=(N, D))).astype(np.float32)
    price = rng.uniform(0, 100, N).astype(np.float32)
    return TTable("t").add_vector("v", vec + np.float32(shift)) \
        .add_numeric("price", price)


@pytest.fixture(scope="module")
def platform():
    """(a prepared CPU platform, the median 100th-neighbour distance)."""
    p = MQRLD(_table(), seed=0, device="cpu")
    p.prepare(min_leaf=32, max_leaf=256)
    tab = p.table.vector["v"]
    d = np.sqrt(((tab[:64, None] - tab[None]) ** 2).sum(-1))
    return p, float(np.median(np.sort(d, axis=1)[:, 100]))


def _batch(tab, radius, seed=1):
    """The four archetypes round-robin: VK, NR+VK, VR+NR, VR+VK."""
    rng = np.random.default_rng(seed)
    out = []
    for j, i in enumerate(rng.integers(0, len(tab), BATCH)):
        v = tab[i]
        out.append([
            TQ.VK.of("v", v, 20),
            TQ.And.of(TQ.NR("price", 25, 75), TQ.VK.of("v", v, 20)),
            TQ.And.of(TQ.VR.of("v", v, radius), TQ.NR("price", 20, 80)),
            TQ.And.of(TQ.VR.of("v", v, radius), TQ.VK.of("v", v, 20)),
        ][j % 4])
    return out


def _traced(fn):
    """(fn()'s result, the tracer that recorded it)."""
    tr = tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tr


def test_off_records_nothing(platform):
    p, radius = platform
    assert tracing.current() is None
    a, b = tracing.span("engine.masks"), tracing.span("planner.execute")
    assert a is b
    with a as got:
        assert got is None
    tracing.count("engine.syncs", 3)
    p.session().plan(_batch(p.table.vector["v"], radius)).execute()
    assert tracing.current() is None


def test_spans_nest_in_one_batch(platform):
    p, radius = platform
    sess = p.session()
    (rows, st), tr = _traced(lambda: sess.plan(
        _batch(p.table.vector["v"], radius)).execute())
    spans = tr.spans
    assert all(s is not None for s in spans)
    names = [s.name for s in spans]
    assert set(PARENT) | {"planner.plan"} == set(names)
    plan = spans[names.index("planner.plan")]
    assert plan.parent == -1
    root = names.index("planner.execute")
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.name == "planner.plan":
            continue
        assert s.batch == root
        want = PARENT[s.name]
        if want is None:
            assert s.parent == -1
            continue
        parent = spans[s.parent]
        assert parent.name == want
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    # one set of KNN spans per group, two record blocks a batch
    assert names.count("engine.upload") == len(st.knn_group_widths)
    assert names.count("planner.record") == 2


def test_rows_and_stats_are_the_untraced_ones(platform):
    p, radius = platform
    queries = _batch(p.table.vector["v"], radius, seed=7)
    # a first run settles the QBS seeds the later ones read
    p.session().plan(queries).execute()
    want, ws = p.session().plan(queries).execute()
    (got, gs), _ = _traced(lambda: p.session().plan(queries).execute())
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for key in ws.__dataclass_fields__:
        if key != "time_s" and key != "stage_samples":
            assert getattr(gs, key) == getattr(ws, key), key
    assert [s[:2] for s in gs.stage_samples] == \
        [s[:2] for s in ws.stage_samples]


def test_counters_repeat_over_identical_batches(platform):
    p, radius = platform
    queries = _batch(p.table.vector["v"], radius, seed=5)
    p.session().plan(queries).execute()
    counts = []
    for _ in range(2):
        _, tr = _traced(lambda: p.session().plan(queries).execute())
        counts.append(dict(tr.counters))
    assert counts[0] == counts[1]
    assert counts[0]["engine.syncs"] > 0
    assert counts[0]["engine.readback_bytes"] > 0


def test_dense_radius_route_reads_its_masks_back(platform):
    p, radius = platform
    queries = _batch(p.table.vector["v"], 4 * radius, seed=3)
    (_, st), tr = _traced(lambda: p.session().plan(queries).execute())
    assert st.vr_dense_fallbacks > 0
    g = sum(isinstance(q, TQ.And) and isinstance(q.parts[0], TQ.VR)
            for q in queries)
    assert tr.counters["engine.readback_bytes"] >= g * N


def test_an_unproven_rerank_records_the_widening():
    """Rows far from the origin: the fp32 expansion cannot certify any
    re-rank, so every job takes the exact widening pass."""
    p = MQRLD(_table(shift=3000.0), seed=0, device="cpu")
    p.prepare(min_leaf=32, max_leaf=256)
    tab = p.table.vector["v"]
    queries = [TQ.VK.of("v", tab[i], 20) for i in (0, 411, 977)]
    (_, st), tr = _traced(lambda: p.session().plan(queries).execute())
    assert st.knn_exact_fallbacks == len(queries)
    widen = [s for s in tr.spans if s.name == "engine.widen"]
    assert len(widen) == 1
    assert tr.spans[widen[0].parent].name == "planner.execute"


def test_spans_keep_their_threads_apart():
    """Each thread's spans nest on that thread alone."""
    tr = tracing.enable()
    try:
        go = threading.Barrier(2, timeout=30)

        def work():
            with tracing.span("outer"):
                go.wait()
                with tracing.span("inner"):
                    go.wait()
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        tracing.disable()
    assert len(tr.spans) == 4
    for s in tr.spans:
        if s.name == "inner":
            outer = tr.spans[s.parent]
            assert outer.name == "outer" and outer.thread == s.thread
            assert s.batch == s.parent


def test_a_span_entered_while_off_stays_off():
    with tracing.span("engine.masks"):
        tr = tracing.enable()
        with tracing.span("engine.walk"):
            tracing.count("engine.syncs")
    tracing.disable()
    assert [s.name for s in tr.spans] == ["engine.walk"]
    assert tr.spans[0].parent == -1
    assert tr.counters == {"engine.syncs": 1}
