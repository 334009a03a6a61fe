"""The pipelined serving executor in the port — the reference's
``tests/test_pipeline.py`` on the port's ``RetrievalServer`` and
``ChunkPipeline``: depth-1 parity with the serial loop, in-order future
resolution under overlap, mid-pipeline failure isolation, the drain at
an append and a generation swap, prewarm hygiene, the QBS lock, and a
seeded fuzz of submit / poll / flush_one / append / swap + rollback at
depth 3. A stub embedder (per prompt, independent of the batch) over a
small platform on the CPU; nothing sleeps.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.serve.engine import RetrievalRequest, RetrievalServer
from repro_torch.serve.pipeline import ChunkPipeline

torch.set_num_threads(1)


def _sorted(rows):
    return np.sort(np.asarray(rows))


@pytest.fixture(scope="module")
def platform():
    rng = np.random.default_rng(11)
    n, d = 900, 8
    centers = rng.normal(size=(5, d)).astype(np.float32) * 6
    lab = rng.integers(0, 5, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    t = (MMOTable("pipe_shop")
         .add_vector("img", vec)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = MQRLD(t, seed=0, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p


class _StubEmbedder:
    def __init__(self, table):
        self.table = table
        self.calls = 0

    def embed(self, tokens):
        self.calls += 1
        rows = np.asarray(tokens)[:, 0] % self.table.n_rows
        return self.table.vector["img"][rows] + 0.01


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _req(i, k=6, predicate=None, deadline_ms=None):
    return RetrievalRequest(tokens=np.asarray([i, 1], np.int32),
                            attr="img", k=k, predicate=predicate,
                            deadline_ms=deadline_ms)


def _mixed_requests(n=14):
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(_req(i, k=5))
        elif i % 3 == 1:
            out.append(_req(i, k=9))
        else:
            out.append(_req(i, k=4, predicate=Q.NR("price", 10, 90)))
    return out


def _srv(platform, **kw):
    return RetrievalServer(platform, _StubEmbedder(platform.table),
                           batch_size=4, **kw)


# ---------------------------------------------------------------------------
# construction / depth-1 parity
# ---------------------------------------------------------------------------
def test_depth_validation(platform):
    with pytest.raises(ValueError):
        _srv(platform, pipeline_depth=0)
    with pytest.raises(ValueError):
        ChunkPipeline(object(), 1)


def test_depth1_is_serial(platform):
    srv = _srv(platform, pipeline_depth=1)
    assert srv._pipe is None and srv.inflight_chunks == 0
    ref = _srv(platform)
    reqs = _mixed_requests()
    a = srv.serve(reqs)
    b = ref.serve(list(reqs))
    assert srv.n_batches == ref.n_batches
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert np.array_equal(ra.rows, rb.rows), i
    assert srv.stats()["pipeline_depth"] == 1


# ---------------------------------------------------------------------------
# overlap exactness + ordering
# ---------------------------------------------------------------------------
def test_pipelined_exactness_and_order(platform):
    p = platform
    reqs = _mixed_requests(18)
    ref = _srv(p).serve(list(reqs))
    srv = _srv(p, pipeline_depth=3)
    res = srv.serve(reqs)
    assert srv.inflight_chunks == 0
    assert srv.n_batches == srv.stats()["batches"] > 1
    for i, (ra, rb) in enumerate(zip(res, ref)):
        assert np.array_equal(ra.rows, rb.rows), i
        assert not ra.shed
        assert _sorted(ra.rows).tolist() == \
            _sorted(p.oracle(ra.query)).tolist(), i


def test_poll_driven_overlap(platform):
    p = platform
    reqs = _mixed_requests(16)
    ref = _srv(p).serve(list(reqs))
    srv = _srv(p, pipeline_depth=2)
    futs, saw_inflight = [], False
    for r in reqs:
        futs.append(srv.submit(r))
        saw_inflight = saw_inflight or srv.inflight_chunks > 0
    spins = 0
    while not all(f.done() for f in futs):
        srv.poll()
        spins += 1
        assert spins < 300, "poll loop did not converge"
    assert saw_inflight
    for i, (f, rb) in enumerate(zip(futs, ref)):
        assert np.array_equal(f.result().rows, rb.rows), i


def test_shed_skips_inflight(platform):
    clk = _FakeClock()
    srv = _srv(platform, pipeline_depth=2, clock=clk)
    futs = [srv.submit(_req(i, k=5, deadline_ms=50.0)) for i in range(4)]
    assert srv.inflight_chunks == 1
    clk.advance(10.0)
    srv.flush()
    assert all(f.done() for f in futs)
    assert all(not f.result().shed for f in futs)
    assert srv.n_shed == 0
    late = srv.submit(_req(99, k=5, deadline_ms=1.0))
    clk.advance(1.0)
    srv.flush()
    assert late.result().shed and srv.n_shed == 1


# ---------------------------------------------------------------------------
# failure isolation
# ---------------------------------------------------------------------------
def test_mid_pipeline_failure_isolated(platform):
    p = platform
    srv = _srv(p, pipeline_depth=3)
    boom = {"on": False}
    real_ranked = srv._ranked

    def flaky(req, emb, rows):
        if boom["on"] and req.k == 9:
            raise RuntimeError("injected epilogue failure")
        return real_ranked(req, emb, rows)

    srv._ranked = flaky
    f_a = [srv.submit(_req(i, k=5)) for i in range(4)]
    f_b = [srv.submit(_req(i, k=9)) for i in range(4)]
    f_c = [srv.submit(_req(i, k=4, predicate=Q.NR("price", 10, 90)))
           for i in range(4)]
    assert srv.inflight_chunks == 3
    assert srv.flush_one() == 4
    first = [f.result() for f in f_a]
    boom["on"] = True
    with pytest.raises(RuntimeError, match="injected"):
        srv.flush()
    assert all(not f.done() for f in f_b)
    assert srv.queue_depth == 8
    assert srv.inflight_chunks == 1
    for f, r in zip(f_a, first):
        assert f.result() is r
    boom["on"] = False
    srv.flush()
    ref = _srv(p)
    for f, r in zip(f_b, ref.serve([_req(i, k=9) for i in range(4)])):
        assert np.array_equal(f.result().rows, r.rows)
    for f in f_c:
        assert _sorted(f.result().rows).tolist() == \
            _sorted(p.oracle(f.result().query)).tolist()


def test_dispatch_failure_leaves_chunk_pending(platform):
    """A chunk whose dispatch raises (here its embedding) leaves its
    requests queued and unresolved; chunks already in flight are
    untouched and the retry serves everything."""
    class _Flaky(_StubEmbedder):
        fail = False

        def embed(self, tokens):
            if self.fail:
                self.fail = False
                raise RuntimeError("embed failed")
            return super().embed(tokens)

    emb = _Flaky(platform.table)
    srv = RetrievalServer(platform, emb, batch_size=4, pipeline_depth=2)
    f_a = [srv.submit(_req(i, k=5)) for i in range(4)]
    assert srv.inflight_chunks == 1
    emb.fail = True
    with pytest.raises(RuntimeError, match="embed failed"):
        for i in range(4):
            srv.submit(_req(i, k=9))
    assert srv.inflight_chunks == 1 and srv.queue_depth == 8
    srv.flush()
    assert all(f.done() for f in f_a)
    assert srv.n_served == 8 and srv.queue_depth == 0


# ---------------------------------------------------------------------------
# quiescent boundaries: append
# ---------------------------------------------------------------------------
def test_append_drains_pipeline(platform):
    rng = np.random.default_rng(5)
    vec = platform.table.vector["img"]
    reqs = [_req(i, k=5) for i in range(4)]
    ref = _srv(platform).serve(list(reqs))
    srv = _srv(platform, pipeline_depth=2)
    pre = [srv.submit(r) for r in reqs]
    assert srv.inflight_chunks == 1
    n_before = platform.view().n_rows
    srv.append(vectors={"img": (vec[:3] + rng.normal(scale=0.01,
               size=(3, vec.shape[1]))).astype(np.float32)},
               numeric={"price": np.asarray([5., 6., 7.], np.float32)},
               fold=False)
    assert srv.inflight_chunks == 0
    assert platform.view().n_rows == n_before + 3
    assert all(f.done() for f in pre)
    for f, r in zip(pre, ref):
        assert np.array_equal(f.result().rows, r.rows)
    post = srv.serve([_req(i, k=5) for i in range(4, 8)])
    for r in post:
        assert _sorted(r.rows).tolist() == \
            _sorted(platform.oracle(r.query)).tolist()


def test_swap_at_drained_boundary(platform):
    """A generation swap after drain() serves exact results before and
    after: in-flight work resolves before the swap, later requests run
    against the new generation (compared by the oracle, which follows
    the layout)."""
    p = platform
    srv = _srv(p, pipeline_depth=2)
    pre = [srv.submit(_req(i, k=6)) for i in range(4)]
    assert srv.inflight_chunks == 1
    served = srv.drain()
    assert served == 4 and srv.inflight_chunks == 0
    # a swap re-permutes physical rows, so rows from before it compare
    # with the oracle only before the flip
    for f in pre:
        r = f.result()
        assert _sorted(r.rows).tolist() == \
            _sorted(p.oracle(r.query)).tolist()
    gen = p.build_generation(theta=[0.06, -0.04])
    p.swap(gen)
    try:
        post = srv.serve(_mixed_requests(8))
        for r in post:
            assert _sorted(r.rows).tolist() == \
                _sorted(p.oracle(r.query)).tolist()
    finally:
        p.rollback()


def test_drain_then_fold_serves_the_new_build(platform):
    """A fold after ``drain()`` (the quiescent boundary of a generation
    swap too) serves exact rows before and after it."""
    p = platform
    srv = _srv(p, pipeline_depth=2)
    pre = [srv.submit(_req(i, k=6)) for i in range(4)]
    assert srv.inflight_chunks == 1
    assert srv.drain() == 4 and srv.inflight_chunks == 0
    for f in pre:
        r = f.result()
        assert _sorted(r.rows).tolist() == \
            _sorted(p.oracle(r.query)).tolist()
    rng = np.random.default_rng(6)
    p.append(vector={"img": p.table.vector["img"][:2] + 0.2},
             numeric={"price": rng.uniform(0, 100, 2).astype(np.float32)},
             fold=False)
    build = p.build_id
    p.fold()
    assert p.build_id == build + 1
    for r in srv.serve(_mixed_requests(8)):
        assert _sorted(r.rows).tolist() == \
            _sorted(p.oracle(r.query)).tolist()


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------
def test_prewarm_partial_shapes(platform):
    p = platform
    srv = _srv(p, pipeline_depth=2)
    for f in [srv.submit(_req(i, k=7)) for i in range(4)]:
        f.result()
    sig = srv.signature(_req(0, k=7))
    qbs = p.qbs

    def _ring_sizes():
        return ({k: len(v) for k, v in qbs.convergence.items()},
                {k: len(v) for k, v in qbs.workload.items()},
                {k: len(v) for k, v in qbs.latency.items()})

    before = _ring_sizes()
    assert srv._pipe._warm_queue or srv._pipe._warm_pending is not None
    spins = 0
    while srv._pipe._warm_queue or srv._pipe._warm_pending is not None:
        assert srv.poll() == 0
        spins += 1
        assert spins < 50
    sizes = {len(k[0]) for k in srv.session._cache
             if k[0] and all(s == sig for s in k[0])}
    assert {1, 2, 4} <= sizes
    assert _ring_sizes() == before


# ---------------------------------------------------------------------------
# QBS ring thread-safety
# ---------------------------------------------------------------------------
def test_qbs_concurrent_recording():
    from repro_torch.core.qbs import (_CONVERGENCE_KEEP, _COST_KEEP,
                                      _LATENCY_KEEP, QBSTable)
    qbs = QBSTable()
    n_threads, n_iter = 8, 300
    start = threading.Barrier(n_threads)

    def hammer(t):
        start.wait()
        for i in range(n_iter):
            qbs.record_cost("knn_device", (1.0, 2.0, 3.0), 0.001 * t)
            qbs.record_convergence(f"sig{t % 2}", 3)
            qbs.record_latency(f"sig{t % 2}", 0.01, n=1)
            qbs.cost_samples("knn_device")
            qbs.latency_quantiles(f"sig{t % 2}")

    ts = [threading.Thread(target=hammer, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    assert qbs.cost_total == n_threads * n_iter
    assert len(qbs.cost["knn_device"]) <= _COST_KEEP
    for s in ("sig0", "sig1"):
        assert len(qbs.convergence[s]) <= _CONVERGENCE_KEEP
        assert len(qbs.latency[s]) <= _LATENCY_KEEP
        assert qbs.latency_quantiles(s)["n"] >= 8


# ---------------------------------------------------------------------------
# fuzz: interleaved submit/poll/append/swap at depth 3
# ---------------------------------------------------------------------------
def test_fuzz_interleaved_ops(platform):
    """Seeded interleaving of submit / poll / flush_one / append /
    swap + rollback at depth 3. Resolved futures are exact against the
    oracle of their own query, and every platform change lands at a
    drained boundary."""
    p = platform
    rng = np.random.default_rng(7)
    srv = _srv(p, pipeline_depth=3)
    vec_d = p.table.vector["img"].shape[1]
    futs = []
    checked = set()
    i_req = 0
    swapped = False

    def check_resolved():
        for j, f in enumerate(futs):
            if j in checked or not f.done():
                continue
            r = f.result()
            assert not r.shed
            assert _sorted(r.rows).tolist() == \
                _sorted(p.oracle(r.query)).tolist(), j
            checked.add(j)

    try:
        for step in range(120):
            op = rng.choice(["submit", "submit", "submit", "poll",
                             "flush_one", "append", "swap"])
            if op == "submit":
                kind = i_req % 3
                futs.append(srv.submit(
                    _req(i_req, k=5) if kind == 0 else
                    _req(i_req, k=9) if kind == 1 else
                    _req(i_req, k=4, predicate=Q.NR("price", 10, 90))))
                i_req += 1
            elif op == "poll":
                srv.poll()
            elif op == "flush_one":
                srv.flush_one()
            elif op == "append":
                srv.drain()
                check_resolved()             # settle before mutating
                row = rng.normal(size=(1, vec_d)).astype(np.float32)
                # fold=False: an auto-fold would re-permute physical rows
                # under results checked after it
                srv.append(vectors={"img": row},
                           numeric={"price": np.asarray([50.0], np.float32)},
                           fold=False)
                assert srv.inflight_chunks == 0
            elif op == "swap" and not swapped:
                srv.drain()
                check_resolved()
                p.swap(p.build_generation(theta=[0.05, -0.03]))
                swapped = True
            check_resolved()
        srv.flush()
        assert srv.inflight_chunks == 0
        check_resolved()
        assert len(checked) == len(futs)
        assert swapped
    finally:
        if swapped:
            p.rollback()
