"""The retrieval server in the port: ``RetrievalServer`` on the planned
path, and the async split of the engine and the planner it rides on.

* The reference's ``RetrievalServer`` tests (``tests/test_serve.py``) on
  the port: coalesced exactness against per-request serving and the
  oracle, submission order, power-of-two chunk sizes, deadline and
  predictive shedding on a fake clock (nothing sleeps), backpressure,
  all-or-nothing chunks and immutable futures, latency fed to QBS and
  ``explain()``, the QBS latency rings across a save and load, and
  length-bucketed embedding; and the three ``test_server_append_*``
  tests of ``tests/test_ingest.py``.
* Parity with the reference on carried state (``state_from_numpy``): the
  reference's server and the port's get the same request stream (windows,
  deadlines, polls and flushes on one fake clock) at pipeline depth 1 and
  3 and give, request by request, the same rows, the same chunks in the
  same order, the same shed set and the same ``stats()``.
* ``execute_batch_async(...).materialize()`` equals ``execute_batch`` on
  both loops, in fp32, int8 and bf16, with and without a live delta: rows
  and every ``EngineStats`` field but ``time_s`` (and, unless asked for,
  the KNN stages' wall-time samples); ``execute_async`` records into QBS
  only at ``materialize()``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import query as JQ
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro.serve.engine import RetrievalRequest as JRequest
from repro.serve.engine import RetrievalServer as JServer
from repro_torch.configs import get_config
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.persist import load_platform, save_platform
from repro_torch.core.platform import MQRLD, state_from_numpy
from repro_torch.core.qbs import QBSTable
from repro_torch.serve.engine import (EmbeddingServer, RetrievalFuture,
                                      RetrievalRequest, RetrievalResult,
                                      RetrievalServer)
from repro_torch.utils import quant
from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)


def _sorted(rows):
    return np.sort(np.asarray(rows))


def _serve_table(M, name="serve_shop"):
    rng = np.random.default_rng(11)
    n, d = 900, 8
    centers = rng.normal(size=(5, d)).astype(np.float32) * 6
    lab = rng.integers(0, 5, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return (M(name).add_vector("img", vec)
            .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))


@pytest.fixture(scope="module")
def platform():
    p = MQRLD(_serve_table(MMOTable), seed=0, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p


class _StubEmbedder:
    """Deterministic per prompt, independent of batch composition."""

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


def _req(i, k=6, predicate=None, deadline_ms=None, R=RetrievalRequest):
    return R(tokens=np.asarray([i, 1], np.int32), attr="img", k=k,
             predicate=predicate, deadline_ms=deadline_ms)


def _mixed_requests(n=14, R=RetrievalRequest, M=Q):
    """Three interleaved archetypes: V.K k=5, V.K k=9, N.R + V.K k=4."""
    out = []
    for i in range(n):
        if i % 3 == 0:
            out.append(_req(i, k=5, R=R))
        elif i % 3 == 1:
            out.append(_req(i, k=9, R=R))
        else:
            out.append(_req(i, k=4, predicate=M.NR("price", 10, 90), R=R))
    return out


# ---------------------------------------------------------------------------
# exactness of coalesced serving
# ---------------------------------------------------------------------------
def test_coalesced_exactness_vs_per_request_oracle(platform):
    p = platform
    reqs = _mixed_requests()
    solo = []
    for r in reqs:
        srv1 = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4)
        solo.append(srv1.serve([r])[0])
    fifo = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                           coalesce=False).serve(reqs)
    coal = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4)
    res = coal.serve(reqs)
    assert coal.n_batches > 1
    for i, (a, b, c) in enumerate(zip(res, fifo, solo)):
        assert np.array_equal(a.rows, b.rows), i
        assert np.array_equal(a.rows, c.rows), i
        assert not a.shed and a.latency_s >= 0.0
        assert _sorted(a.rows).tolist() == \
            _sorted(p.oracle(a.query)).tolist(), i


def test_submission_order_under_coalescing(platform):
    p = platform
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=3)
    fa = srv.submit(_req(0, k=5))
    fbs = [srv.submit(_req(10 + i, k=8)) for i in range(3)]
    assert all(f.done() for f in fbs) and not fa.done()
    assert srv.queue_depth == 1
    srv.flush()
    assert fa.done()
    for f, r in zip([fa] + fbs, [_req(0, k=5)] +
                    [_req(10 + i, k=8) for i in range(3)]):
        alone = RetrievalServer(p, _StubEmbedder(p.table)).serve([r])[0]
        assert np.array_equal(f.result().rows, alone.rows)


def test_chunk_sizes_pow2_quantized(platform):
    p = platform
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=8)
    futs = [srv.submit(_req(i, k=6)) for i in range(6)]
    assert srv.queue_depth == 6
    assert srv.flush_one() == 4
    assert srv.flush_one() == 2
    assert srv.n_batches == 2
    assert all(f.done() for f in futs)


# ---------------------------------------------------------------------------
# deadline shedding
# ---------------------------------------------------------------------------
def test_deadline_shedding_observable(platform):
    p = platform
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=clk)
    f_live = srv.submit(_req(0, k=6))
    f_dead = srv.submit(_req(1, k=6, deadline_ms=50.0))
    clk.advance(0.2)
    srv.flush()
    r = f_dead.result()
    assert r.shed and r.query is None and len(r.rows) == 0
    assert r.latency_s == pytest.approx(0.2)
    live = f_live.result()
    assert not live.shed and len(live.rows) == 6
    st = srv.stats()
    assert st["shed"] == 1 and st["served"] == 1 and st["submitted"] == 2


def test_shed_only_queue_runs_no_compute(platform):
    p = platform
    clk = _FakeClock()
    emb = _StubEmbedder(p.table)
    srv = RetrievalServer(p, emb, batch_size=4, clock=clk)
    futs = [srv.submit(_req(i, deadline_ms=10.0)) for i in range(3)]
    clk.advance(1.0)
    calls0 = emb.calls
    srv.flush()
    assert emb.calls == calls0
    assert all(f.result().shed for f in futs)
    assert srv.stats()["shed"] == 3 and srv.n_served == 0


def test_predictive_shedding_uses_qbs_service_time(platform):
    p = platform
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=clk)
    sig = srv.signature(_req(0, k=6))
    p.qbs.record_latency(sig, 0.5, n=8)
    f = srv.submit(_req(0, k=6, deadline_ms=100.0))
    srv.flush()
    assert f.result().shed
    f2 = srv.submit(_req(1, k=7, deadline_ms=100.0))
    srv.flush()
    assert not f2.result().shed
    del p.qbs.latency[sig]


def test_adaptive_window_and_next_due(platform):
    """A warm signature's window is one full-batch service time (capped
    by ``max_delay_ms``); ``poll`` waits it out and ``next_due`` names
    when."""
    p = platform
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=clk, max_delay_ms=50.0, adaptive_window=True)
    sig = srv.signature(_req(0, k=3))
    assert srv._window_s(sig) == pytest.approx(0.05)   # cold: static
    p.qbs.record_latency(sig, 0.002, n=8)
    try:
        assert srv._window_s(sig) == pytest.approx(0.008)
        f = srv.submit(_req(0, k=3))
        assert srv.poll() == 0 and not f.done()
        assert srv.next_due() == pytest.approx(clk.t + 0.008)
        clk.advance(0.01)
        assert srv.poll() == 1 and f.done()
        assert srv.next_due() is None
    finally:
        del p.qbs.latency[sig]


# ---------------------------------------------------------------------------
# bounded admission / backpressure
# ---------------------------------------------------------------------------
def test_backpressure_bounds_queue(platform):
    p = platform
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=16,
                          max_queue=5)
    futs = []
    for i in range(30):
        futs.append(srv.submit(_mixed_requests(30)[i]))
        assert srv.queue_depth <= 5
    srv.flush()
    assert all(f.done() for f in futs)
    st = srv.stats()
    assert st["submitted"] == 30
    assert st["served"] + st["shed"] == 30 and st["shed"] == 0
    assert st["queue_depth"] == 0


def test_max_queue_validation(platform):
    with pytest.raises(ValueError, match="max_queue"):
        RetrievalServer(platform, _StubEmbedder(platform.table),
                        max_queue=0)


def test_later_items_raise(platform):
    """Nothing of the server raises for a later item any more: ``shards=2``
    serves through a two-shard session, rows the oracle's."""
    srv = RetrievalServer(platform, _StubEmbedder(platform.table), shards=2)
    assert srv.session.shards == 2
    req = RetrievalRequest(tokens=np.asarray([3, 1], np.int32), attr="img",
                           k=5)
    (res,) = srv.serve([req])
    assert np.array_equal(res.rows, platform.oracle(res.query))


def test_attach_reopt_steps_the_controller(platform):
    """``attach_reopt`` gives a session-less controller the server's
    session; ``poll()`` steps it and ``stats()`` reports its status."""
    from repro_torch.core.reopt import ReoptConfig, ReoptController
    srv = RetrievalServer(platform, _StubEmbedder(platform.table))
    ctl = ReoptController(platform, config=ReoptConfig(
        min_queries=10 ** 9))
    srv.attach_reopt(ctl)
    assert srv.reopt is ctl and ctl.session is srv.session
    assert srv.poll() == 0
    st = srv.stats()["reopt"]
    assert st["state"] == "idle" and st["swaps"] == 0
    assert st["build_id"] == platform.build_id


# ---------------------------------------------------------------------------
# failure injection: all-or-nothing chunks, immutable futures
# ---------------------------------------------------------------------------
def test_embedder_raises_mid_flush_retryable(platform):
    class _Flaky(_StubEmbedder):
        def __init__(self, table):
            super().__init__(table)
            self.fail = True

        def embed(self, tokens):
            if self.fail:
                self.fail = False
                raise RuntimeError("transient embedder failure")
            return super().embed(tokens)

    p = platform
    srv = RetrievalServer(p, _Flaky(p.table), batch_size=4)
    futs = [srv.submit(_req(i, k=6)) for i in range(3)]
    with pytest.raises(RuntimeError, match="transient"):
        srv.flush()
    assert not any(f.done() for f in futs)
    assert srv.queue_depth == 3
    srv.flush()
    for f in futs:
        assert len(f.result().rows) == 6


def test_failed_chunk_never_reresolves_earlier_chunk(platform):
    p = platform
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=2)
    f_ok = [srv.submit(_req(i, k=5)) for i in range(2)]
    assert all(f.done() for f in f_ok)
    first_results = [f.result() for f in f_ok]
    f_bad = [srv.submit(_req(10 + i, k=9)) for i in range(1)]
    orig_ranked = srv._ranked

    def _boom(req, emb, rows):
        raise RuntimeError("rank gather failed")

    srv._ranked = _boom
    try:
        with pytest.raises(RuntimeError, match="rank gather"):
            srv.flush()
    finally:
        srv._ranked = orig_ranked
    assert not any(f.done() for f in f_bad) and srv.queue_depth == 1
    srv.flush()
    assert all(f.done() for f in f_bad)
    for f, r0 in zip(f_ok, first_results):
        assert f.result() is r0


def test_mid_chunk_rank_failure_leaves_all_unresolved(platform):
    p = platform
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4)
    futs = [srv.submit(_req(i, k=6)) for i in range(3)]
    orig = srv._ranked
    n_calls = [0]

    def _boom_on_second(req, emb, rows):
        n_calls[0] += 1
        if n_calls[0] == 2:
            raise RuntimeError("mid-chunk failure")
        return orig(req, emb, rows)

    srv._ranked = _boom_on_second
    try:
        with pytest.raises(RuntimeError, match="mid-chunk"):
            srv.flush()
    finally:
        srv._ranked = orig
    assert not any(f.done() for f in futs)
    srv.flush()
    for r in [f.result() for f in futs]:
        assert _sorted(r.rows).tolist() == \
            _sorted(p.oracle(r.query)).tolist()


def test_future_set_is_idempotent(platform):
    srv = RetrievalServer(platform, _StubEmbedder(platform.table))
    fut = RetrievalFuture(srv)
    first = RetrievalResult(rows=np.asarray([1, 2]))
    fut._set(first)
    fut._set(RetrievalResult(rows=np.asarray([9])))
    assert fut.result() is first


# ---------------------------------------------------------------------------
# latency accounting -> QBS -> explain()
# ---------------------------------------------------------------------------
def test_latency_feeds_qbs_and_explain(platform):
    p = platform
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=clk)
    reqs = [_req(i, k=3, predicate=Q.NR("price", 20, 80))
            for i in range(5)]
    sig = srv.signature(reqs[0])
    before = p.qbs.latency_quantiles(sig)
    srv.serve(reqs)
    lq = p.qbs.latency_quantiles(sig)
    assert lq is not None and lq["n"] == (before["n"] if before else 0) + 5
    assert lq["p50"] >= 0.0 and lq["p99"] >= lq["p50"]
    emb = p.table.vector["img"][0]
    q = Q.And.of(Q.NR("price", 20, 80), Q.VK.of("img", emb, 3))
    ex = srv.session.explain([q])
    frag = ex["fragments"][0]
    assert frag["query"] == sig
    assert frag["latency"] is not None and frag["latency"]["n"] == lq["n"]
    st = srv.stats()
    assert sig in st["by_signature"]
    assert st["by_signature"][sig]["n"] == 5


def test_qbs_latency_persist_roundtrip(tmp_path):
    """test_serve.py's, and the reference reads the port's file."""
    from repro.core.qbs import QBSTable as JQBSTable
    t = QBSTable()
    t.record_latency("VK:img:k4:global", 0.01, n=3)
    t.record_latency("And(NR:price,VK:img:k2:post)", 0.25)
    path = str(tmp_path / "qbs.json")
    t.save(path)
    for cls in (QBSTable, JQBSTable):
        t2 = cls.load(path)
        assert t2.latency == t.latency
        assert t2.latency_quantiles("VK:img:k4:global")["n"] == 3


def test_latency_rings_survive_a_platform_snapshot(platform, tmp_path):
    """The served latencies ride in the snapshot's qbs.json."""
    srv = RetrievalServer(platform, _StubEmbedder(platform.table),
                          batch_size=4, clock=_FakeClock())
    srv.serve([_req(i, k=2) for i in range(4)])
    sig = srv.signature(_req(0, k=2))
    save_platform(platform, str(tmp_path))
    p2 = load_platform(str(tmp_path), device="cpu")
    assert p2.qbs.latency_quantiles(sig) == \
        platform.qbs.latency_quantiles(sig)


def test_embed_tokens_bucketing_padding_invariance(platform):
    """Embeddings are padding-free: each mixed-length prompt's embedding
    matches embedding it alone, and a permuted batch gives identical
    vectors (the port's ``EmbeddingServer``, reduced, on the CPU)."""
    cfg = get_config("mqrld-embedder-100m").reduced()
    emb_srv = EmbeddingServer(cfg, device="cpu", seed=0)
    srv = RetrievalServer(platform, emb_srv)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 60, size=n).astype(np.int32)
               for n in (4, 9, 6, 9, 4)]
    got = srv._embed_tokens(prompts)
    assert got.shape == (5, cfg.d_model)
    for i, t in enumerate(prompts):
        solo = np.asarray(emb_srv.embed(t[None, :]))[0]
        np.testing.assert_allclose(got[i], solo, rtol=2e-5, atol=1e-6)
    perm = [3, 0, 4, 1, 2]
    got_p = srv._embed_tokens([prompts[i] for i in perm])
    for j, i in enumerate(perm):
        np.testing.assert_array_equal(got_p[j], got[i])


def test_retrieval_server_precision_knob(platform):
    """test_precision.py's: int8 serving returns the fp32 rows."""
    reqs = [_req(i, k=6) for i in range(5)]
    ref = RetrievalServer(platform, _StubEmbedder(platform.table),
                          precision="fp32").serve(reqs)
    got = RetrievalServer(platform, _StubEmbedder(platform.table),
                          precision="int8").serve(reqs)
    for a, b in zip(ref, got):
        assert np.array_equal(a.rows, b.rows)


# ---------------------------------------------------------------------------
# RetrievalServer.append (tests/test_ingest.py)
# ---------------------------------------------------------------------------
def _ingest_platform(seed):
    rng = np.random.default_rng(seed)
    n = 500
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 5
    lab = rng.integers(0, 5, n)
    img = (centers[lab] + rng.normal(size=(n, 8))).astype(np.float32)
    audio = rng.normal(size=(n, 5)).astype(np.float32) * 2
    t = (MMOTable("ingest")
         .add_vector("img", img).add_vector("audio", audio)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32))
         .add_numeric("stock", rng.integers(0, 50, n).astype(np.float32)))
    p = MQRLD(t, seed=seed, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p


def _rowset(rows):
    return set(np.asarray(rows).tolist())


def test_server_append_between_submit_and_result():
    p = _ingest_platform(10)
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=100)
    futs = [srv.submit(RetrievalRequest(
        tokens=np.asarray([i, 1], np.int32), attr="img", k=4,
        predicate=Q.NR("price", 0, 100))) for i in (3, 77, 200)]
    assert not any(f.done() for f in futs)
    target = _StubEmbedder(p.table).embed(
        np.asarray([[3, 1]], np.int32))[0]
    rng = np.random.default_rng(13)
    srv.append(numeric={"price": np.full(3, 50.0, np.float32),
                        "stock": np.full(3, 1.0, np.float32)},
               vectors={"img": np.stack([target + 1e-4] * 3),
                        "audio": rng.normal(size=(3, 5)).astype(np.float32)},
               fold=False)
    with pytest.raises(ValueError):
        srv.append(numeric={"price": [1.0]}, vectors={}, fold=False)
    with pytest.raises(ValueError):
        srv.append(tokens=[np.asarray([1], np.int32)])
    assert p.n_delta == 3
    nb = p.table.n_rows
    res = [f.result() for f in futs]
    for r in res:
        assert _rowset(r.rows) == _rowset(p.oracle(r.query))
    assert any(i >= nb for i in res[0].rows.tolist())


def test_server_append_after_flush_does_not_mutate_results():
    p = _ingest_platform(11)
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=2)
    f1 = srv.submit(RetrievalRequest(tokens=np.asarray([5, 1], np.int32),
                                     attr="img", k=3))
    f2 = srv.submit(RetrievalRequest(tokens=np.asarray([9, 1], np.int32),
                                     attr="img", k=3))
    assert f1.done() and f2.done()
    before = f1.result().rows.copy()
    target = _StubEmbedder(p.table).embed(
        np.asarray([[5, 1]], np.int32))[0]
    rng = np.random.default_rng(14)
    srv.append(numeric={"price": [50.0], "stock": [1.0]},
               vectors={"img": target[None, :] + 1e-5,
                        "audio": rng.normal(size=(1, 5)).astype(np.float32)},
               fold=False)
    np.testing.assert_array_equal(f1.result().rows, before)
    f3 = srv.submit(RetrievalRequest(tokens=np.asarray([5, 1], np.int32),
                                     attr="img", k=3))
    srv.flush()
    assert not np.array_equal(f3.result().rows, before)
    assert _rowset(f3.result().rows) == _rowset(p.oracle(f3.result().query))


def test_server_append_tokens_are_embedded():
    p = _ingest_platform(12)
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4)
    rng = np.random.default_rng(15)
    srv.append(tokens=[np.asarray([42, 1], np.int32)], attr="img",
               numeric={"price": [10.0], "stock": [2.0]},
               vectors={"audio": rng.normal(size=(1, 5)).astype(np.float32)},
               fold=False)
    assert p.n_delta == 1
    emb = _StubEmbedder(p.table).embed(np.asarray([[42, 1]], np.int32))[0]
    np.testing.assert_allclose(p.delta.live_vector("img")[0], emb,
                               atol=1e-6)
    out = srv.serve([RetrievalRequest(tokens=np.asarray([42, 1], np.int32),
                                      attr="img", k=1)])
    assert out[0].rows[0] == p.table.n_rows


# ---------------------------------------------------------------------------
# Parity with the reference's server on carried state
# ---------------------------------------------------------------------------
def _stream(R, M):
    """A fixed request stream: three archetypes in turn, every fifth with
    a 5 ms deadline."""
    out = []
    for i in range(24):
        dl = 5.0 if i % 5 == 4 else None
        if i % 3 == 0:
            out.append(_req(i, k=5, deadline_ms=dl, R=R))
        elif i % 3 == 1:
            out.append(_req(i, k=9, deadline_ms=dl, R=R))
        else:
            out.append(_req(i, k=4, predicate=M.NR("price", 10, 90),
                            deadline_ms=dl, R=R))
    return out


def _drive(srv, clk, reqs):
    """Submit the stream, 2 ms of the fake clock apart, with a poll
    after every sixth request, then flush; returns (futures, chunks as
    request indices in run order)."""
    chunks = []
    index = {}
    real = srv._finish_chunk

    def finish(chunk, queries, ranked, t0):
        chunks.append([index[id(p.req)] for p in chunk])
        return real(chunk, queries, ranked, t0)
    srv._finish_chunk = finish
    futs = []
    for i, r in enumerate(reqs):
        index[id(r)] = i
        futs.append(srv.submit(r))
        clk.advance(0.002)
        if i % 6 == 5:
            srv.poll()
    srv.flush()
    return futs, chunks


@pytest.fixture(scope="module")
def carried():
    jp = JMQRLD(_serve_table(JTable), seed=0)
    jp.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return jp, state_from_numpy(ref_state_arrays(jp), device="cpu")


@pytest.mark.parametrize("depth", [1, 3])
def test_server_parity_with_reference(carried, depth):
    jp, pt = carried
    out = []
    for plat, S, R, M in ((jp, JServer, JRequest, JQ),
                          (pt, RetrievalServer, RetrievalRequest, Q)):
        clk = _FakeClock()
        srv = S(plat, _StubEmbedder(plat.table), batch_size=4,
                max_delay_ms=20.0, pipeline_depth=depth, clock=clk)
        futs, chunks = _drive(srv, clk, _stream(R, M))
        out.append(([f.result() for f in futs], chunks, srv.stats()))
    (jres, jchunks, jst), (tres, tchunks, tst) = out
    assert tchunks == jchunks
    assert {1, 2, 4} <= {len(c) for c in tchunks}
    assert [r.shed for r in tres] == [r.shed for r in jres]
    assert any(r.shed for r in tres)
    for i, (a, b) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(a.rows, b.rows, err_msg=str(i))
        assert a.latency_s == b.latency_s, i
    assert tst == jst


# ---------------------------------------------------------------------------
# The async split: materialize() == execute_batch
# ---------------------------------------------------------------------------
def _eq_stats(a, b, cost: bool):
    for f in dataclasses.fields(a):
        if f.name in ("time_s", "stage_samples"):
            continue
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    sa = [(k, tuple(x)) for k, x, _ in a.stage_samples]
    sb = [(k, tuple(x)) for k, x, _ in b.stage_samples]
    if cost:
        assert sa == sb
    else:
        assert sa == [s for s in sb if not s[0].startswith("knn")]


@pytest.fixture(scope="module")
def async_platform():
    p = _ingest_platform(20)
    view = p.table
    qs = []
    for i in (3, 60, 250):
        x, a = view.vector["img"][i], view.vector["audio"][i]
        qs += [Q.VK.of("img", x, 5),
               Q.And.of(Q.NR("price", 20, 80), Q.VK.of("img", x, 7)),
               Q.And.of(Q.VR.of("img", x, 3.0), Q.NR("stock", 5, 40)),
               Q.And.of(Q.VR.of("audio", a, 2.5), Q.VK.of("audio", a, 4))]
    return p, qs


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "int8", "bf16"])
@pytest.mark.parametrize("device_loop", [True, False])
def test_materialize_equals_execute_batch(async_platform, device_loop,
                                          precision, delta):
    p, qs = async_platform
    if delta and not p.n_delta:
        rng = np.random.default_rng(8)
        m = 9
        p.append(numeric={"price": rng.uniform(0, 100, m).astype(np.float32),
                          "stock": rng.integers(0, 50, m).astype(np.float32)},
                 vector={"img": (p.table.vector["img"][:m] + 0.05),
                         "audio": rng.normal(size=(m, 5)).astype(np.float32)},
                 fold=False)
    elif not delta and p.n_delta:
        p.fold()
    eng = p.engine(precision=precision)
    want, ws = eng.execute_batch(qs, device_loop=device_loop)
    for cost in (False, True):
        pend = eng.execute_batch_async(qs, device_loop=device_loop,
                                       record_cost=cost)
        got, gs = pend.materialize()
        assert pend.materialize()[0] is got          # idempotent
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        _eq_stats(gs, ws, cost)
    if delta:
        assert all(a.endswith(":delta") for a, _ in ws.knn_group_widths)


def test_execute_async_records_at_materialize(async_platform):
    """``execute_async`` gives ``execute()``'s rows and stats and writes
    QBS only in ``materialize()``, once; ``record=False`` writes nothing."""
    p, qs = async_platform
    sess = p.session()
    want, ws = sess.plan(qs).execute()
    qbs = p.qbs

    def rings():
        return ({k: len(v) for k, v in qbs.convergence.items()},
                dict(qbs.mix), qbs.cost_total)
    before = rings()
    pend = sess.plan(qs).execute_async()
    assert rings() == before
    got, gs = pend.materialize()
    after = rings()
    assert after != before and after[2] == before[2]   # no cost samples
    pend.materialize()
    assert rings() == after
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert gs.knn_group_widths == ws.knn_group_widths
    sess.plan(qs).execute_async(record=False).materialize()
    assert rings() == after


def test_prewarm_and_signature(async_platform):
    """``Session.prewarm`` inserts the skeletons of each size (and skips
    cached ones), keyed under a given build id, which survives the build
    change to it; ``signature`` is the plan's key string."""
    p, qs = async_platform
    sess = p.session()
    q = qs[1]
    sig = sess.signature(q)
    assert sig == Q.signature(Q.normalize(q))
    assert sess.signature(Q.And.of(Q.NR("price", 20, 80),
                                   Q.VK.of("img", (), 7))) == sig
    n = sess.prewarm([q], sizes=(1, 2, 4))
    assert n == 3 and sess.prewarm([q], sizes=(1, 2, 4)) == 0
    assert sess.plan([q, q]).cache_hit
    nxt = p.build_id + 1
    assert sess.prewarm([q], build_id=nxt, sizes=(2,)) == 1
    rng = np.random.default_rng(9)
    p.append(numeric={"price": rng.uniform(0, 100, 2).astype(np.float32),
                      "stock": np.ones(2, np.float32)},
             vector={"img": p.table.vector["img"][:2] + 0.1,
                     "audio": rng.normal(size=(2, 5)).astype(np.float32)},
             fold=False)
    p.fold()
    assert p.build_id == nxt
    assert sess.plan([q, q]).cache_hit
    assert not sess.plan([q]).cache_hit


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_round_width_is_capped_without_changing_rows(async_platform,
                                                     monkeypatch, precision):
    """A beam round gathers at most ``_ROUND_BYTES`` of tiles (fp32 rows,
    or a reduced-precision scan's codes), however wide a QBS seed asks it
    to be (queries far from every cluster seed rounds over nearly the
    whole table): under a budget that leaves one tile a round, both loops
    take more rounds and return the same rows."""
    from repro_torch.core import engine as teng
    p, qs = async_platform
    eng = p.engine(precision=precision)
    want = {dl: eng.execute_batch(qs, device_loop=dl) for dl in (True, False)}
    tiles = eng.vec_tiles["img"]
    assert teng._round_tiles(16, tiles) * 4 == teng._round_tiles(
        16, tiles, quant.TilePlanes(torch.zeros(tiles.shape, dtype=torch.int8),
                                    None, None, None))
    monkeypatch.setattr(teng, "_ROUND_BYTES", 1)
    assert teng._round_tiles(16, tiles) == 1
    for dl in (True, False):
        got, st = eng.execute_batch(qs, device_loop=dl)
        for a, b in zip(got, want[dl][0]):
            np.testing.assert_array_equal(a, b)
        assert st.knn_rounds > want[dl][1].knn_rounds
