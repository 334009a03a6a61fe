"""The port's scalar path against the JAX package: the executors, the
scalar ``MQRLD.execute``, QBS rows, Algorithm 3 and the measurement.

The reference's prepared platform (3,000 x 12 plus a 6-d vector and two
numeric columns, ``prepare(min_leaf=16, max_leaf=256)``, as in
tests/test_query_platform.py) is carried across with
``state_from_numpy``, so both packages walk one tree over one table.

* ``HostExecutor`` and ``MQRLD.execute`` are host numpy in both: rows in
  the same order, ``QueryStats`` and Algorithm 3's access counts are
  compared for identity.
* ``BatchedExecutor`` (the port's on the CPU runs the plain
  ``topk_l2_masked``; the reference's its Pallas kernel in interpret
  mode): equal ids, distances within 1e-5 relative (fp32 rounding of the
  expansion against the port's exact re-rank), and the host executor's
  rows.
* QBS rows sampled at 0.5 from seed 0 are the same rows; their scores
  equal once the two packages' wall times are set equal.
* ``measurement``: equal labels and centroids, scores within 1e-12.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import index as jidx
from repro.core import measurement as jmeas
from repro.core import qbs as jqbs
from repro.core import query as JQ
from repro.core import reorder as jreo
from repro.core.lake import MMOTable as JTable
from repro.core.planner import Session as JSession
from repro.core.platform import MQRLD as JMQRLD
from repro_torch.core import index as tidx
from repro_torch.core import measurement as tmeas
from repro_torch.core import qbs as tqbs
from repro_torch.core import query as TQ
from repro_torch.core import reorder as treo
from repro_torch.core.lake import MMOTable as TTable
from repro_torch.core.platform import MQRLD, state_from_numpy

from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)

STATS = ("nodes_scanned", "buckets_touched", "rows_scanned", "cbr")
ROW_FIELDS = ("statement", "object_set", "attributes", "types",
              "recall_at_k", "cbr", "accuracy", "task")
TREE_ARRAYS = ("centroid", "radius", "parent", "is_leaf", "bucket_start",
               "bucket_end", "lm_a", "lm_b", "depth")


def _table(M):
    rng = np.random.default_rng(0)
    n, d = 3000, 12
    centers = rng.normal(size=(6, d)).astype(np.float32) * 7
    lab = rng.integers(0, 6, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    vec2 = rng.normal(size=(n, 6)).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    hours = rng.uniform(0, 24, n).astype(np.float32)
    return (M("shop").add_vector("img", vec).add_vector("audio", vec2)
            .add_numeric("price", price).add_numeric("delivery", hours))


@pytest.fixture(scope="module")
def pair():
    """(reference platform, port platform on its carried state)."""
    p = JMQRLD(_table(JTable), seed=0)
    p.prepare(min_leaf=16, max_leaf=256, dpc_max_clusters=6)
    return p, state_from_numpy(ref_state_arrays(p), device="cpu")


def _tree_copy(tree, cls):
    """A ClusterTree of package ``cls`` with copies of ``tree``'s arrays,
    sibling lists and access counts."""
    return cls(**{f: getattr(tree, f).copy() for f in TREE_ARRAYS},
               children=[list(c) for c in tree.children],
               access_count=tree.access_count.copy())


def _forms(M, p):
    """Every query form of tests/test_query_platform.py, a V.K under an
    Or under an And (which the batched engine cannot plan) and an Or of a
    V.K and a V.R."""
    t = p.table
    v = t.vector["img"][5]
    v1, v2 = t.vector["img"][10], t.vector["audio"][10]
    v3 = t.vector["img"][3]
    return {
        "NE": M.NE("price", float(t.numeric["price"][7]), 0.5),
        "NR": M.NR("price", 10, 30),
        "VR": M.VR.of("img", v, 3.0),
        "VK": M.VK.of("img", v, 12),
        "VR_and_NR": M.And.of(M.VR.of("img", v1, 4.0),
                              M.NR("price", 20, 80)),
        "NR_and_VK": M.And.of(M.NR("price", 20, 80), M.VK.of("img", v1, 10)),
        "VR_and_VK": M.And.of(M.VR.of("img", v1, 5.0),
                              M.VK.of("img", v1, 10)),
        "VR_and_VR": M.And.of(M.VR.of("img", v1, 6.0),
                              M.VR.of("audio", v2, 4.0)),
        "NR_or_VR": M.Or.of(M.NR("price", 0, 5), M.VR.of("img", v1, 2.0)),
        "or_and_VK": M.And.of(M.Or.of(M.NR("price", 0, 50),
                                      M.NR("delivery", 0, 6)),
                              M.VK.of("img", v1, 15)),
        "filtered_VK": M.And.of(M.NR("price", 40, 60),
                                M.VK.of("img", v3, 20)),
        "VK_in_or_in_and": M.And.of(
            M.Or.of(M.VK.of("img", v1, 4), M.NR("price", 0, 1)),
            M.NR("price", 0, 60)),
        "VK_or_VR": M.Or.of(M.VK.of("img", v3, 8), M.VR.of("img", v1, 3.0)),
    }


# ---------------------------------------------------------------------------
# HostExecutor
# ---------------------------------------------------------------------------
def _same_host_runs(jt, tt, data, calls):
    """Run ``calls`` ((method, q, arg)) through both packages' host
    executors from zeroed counts: same rows in the same order, same
    stats, same access counts."""
    jt.access_count[:] = 0
    tt.access_count[:] = 0
    jx, tx = jidx.HostExecutor(jt, data), tidx.HostExecutor(tt, data)
    np.testing.assert_array_equal(tx.keys, jx.keys)
    for meth, q, arg in calls:
        jr, js = getattr(jx, meth)(q, arg)
        tr, ts = getattr(tx, meth)(q, arg)
        np.testing.assert_array_equal(tr, jr)
        for key in STATS:
            assert getattr(ts, key) == getattr(js, key), (meth, key)
    np.testing.assert_array_equal(tt.access_count, jt.access_count)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_host_executor_knn_matches_reference(pair, k):
    p, pt = pair
    data = p.enhanced
    rng = np.random.default_rng(k)
    qs = data[rng.integers(0, len(data), 12)] + rng.normal(
        size=(12, data.shape[1])).astype(np.float32) * 0.3
    _same_host_runs(_tree_copy(p.tree, jidx.ClusterTree),
                    _tree_copy(pt.tree, tidx.ClusterTree), data,
                    [("knn", q.astype(np.float32), k) for q in qs])


def test_host_executor_range_matches_reference(pair):
    p, pt = pair
    data = p.enhanced
    rng = np.random.default_rng(2)
    calls = [("range_query", data[rng.integers(len(data))], r)
             for r in (0.5, 2.0, 6.0, 12.0)]
    _same_host_runs(_tree_copy(p.tree, jidx.ClusterTree),
                    _tree_copy(pt.tree, tidx.ClusterTree), data, calls)
    # and the rows are the brute-force ones
    tx = tidx.HostExecutor(pt.tree, data)
    for _, q, r in calls:
        rows, _ = tx.range_query(q, r)
        want = np.nonzero(((data - q) ** 2).sum(1) <= r * r)[0]
        np.testing.assert_array_equal(np.sort(rows), want)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_host_executor_knn_property(seed):
    """Random trees: the port's traversal is the reference's (rows,
    stats, counts) and exact against brute force."""
    rng = np.random.default_rng(seed)
    n, d = 400, 6
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.5, 3)
    tree, perm, _ = jidx.build_index(x, min_leaf=8, max_leaf=64,
                                     dpc_max_clusters=5, seed=seed)
    data = x[perm]
    q = rng.normal(size=d).astype(np.float32)
    tt = _tree_copy(tree, tidx.ClusterTree)
    _same_host_runs(tree, tt, data, [("knn", q, 7)])
    rows, _ = tidx.HostExecutor(tt, data).knn(q, 7)
    d2 = ((data - q) ** 2).sum(1)
    np.testing.assert_allclose(np.sort(d2[rows]),
                               np.sort(d2, kind="stable")[:7], rtol=1e-5)


# ---------------------------------------------------------------------------
# BatchedExecutor
# ---------------------------------------------------------------------------
def _batched_pair(tree_j, tree_t, data, qs, k):
    jd, ji, _ = jidx.BatchedExecutor(tree_j, data, interpret=True).knn(qs, k)
    td, ti, ts = tidx.BatchedExecutor(tree_t, data, device="cpu").knn(qs, k)
    np.testing.assert_array_equal(ti, ji)
    assert 0 < ts.cbr <= 1.0 and ts.rows_scanned > 0
    host = tidx.HostExecutor(_tree_copy(tree_t, tidx.ClusterTree), data)
    for i in range(len(qs)):
        np.testing.assert_array_equal(ti[i], host.knn(qs[i], k)[0])
    return jd, td


@pytest.mark.parametrize("k", [5, 20])
def test_batched_executor_matches_reference_and_host(k):
    """Near the origin, where the reference's fp32 expansion is accurate
    to far below 1e-5: equal ids, distances within 1e-5 relative, and
    the host executor's rows."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(1500, 8)).astype(np.float32)
    tree, perm, _ = jidx.build_index(x, min_leaf=16, max_leaf=128,
                                     dpc_max_clusters=5)
    data = x[perm]
    qs = (data[rng.integers(0, len(data), 8)]
          + rng.normal(size=(8, 8)) * 0.5).astype(np.float32)
    jd, td = _batched_pair(tree, _tree_copy(tree, tidx.ClusterTree), data,
                           qs, k)
    np.testing.assert_allclose(td, jd, rtol=1e-5)


def test_batched_executor_on_the_platforms_index(pair):
    """On the platform's own enhanced features, far from the origin:
    equal ids and the host executor's rows; the port's distances are the
    exact ones, the reference's within its fp32 expansion's error bound
    4 d u (|q|^2 + max |p|^2) in squared distance."""
    p, pt = pair
    data = p.enhanced
    rng = np.random.default_rng(3)
    qs = (data[rng.integers(0, len(data), 8)] + rng.normal(
        size=(8, data.shape[1])) * 0.2).astype(np.float32)
    jd, td = _batched_pair(p.tree, pt.tree, data, qs, 10)
    bound = 4 * data.shape[1] * 2.0 ** -24 * (
        (qs.astype(np.float64) ** 2).sum(1)
        + (data.astype(np.float64) ** 2).sum(1).max())
    err = np.abs(td.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2)
    assert (err <= bound[:, None] * 1.01).all()


def test_batched_executor_exact_where_the_expansion_misorders(pair):
    """Far from the origin the fp32 expansion's error swamps the gaps
    between neighbours: the re-rank cannot be certified, every query
    widens, and the rows are still the brute-force ones."""
    p, pt = pair
    data = p.enhanced + np.float32(3000.0)
    tree = _tree_copy(pt.tree, tidx.ClusterTree)
    tree.centroid = tree.centroid + np.float32(3000.0)
    qs = data[[0, 700, 1900]]
    d, rows, _ = tidx.BatchedExecutor(tree, data, device="cpu").knn(qs, 10)
    for i, q in enumerate(qs):
        d2 = ((data - q) ** 2).sum(1)
        want = np.lexsort((np.arange(len(data)), d2))[:10]
        np.testing.assert_array_equal(rows[i], want)
        np.testing.assert_allclose(d[i], np.sqrt(d2[want]), rtol=1e-6)


def test_batched_executor_pads_past_the_table(pair):
    _, pt = pair
    data = pt.table.vector["img"][:40]
    tree, perm, _ = tidx.build_index(data, min_leaf=8, max_leaf=16,
                                     device="cpu")
    d, rows, _ = tidx.BatchedExecutor(tree, data[perm], device="cpu",
                                      tile=8).knn(data[perm][:2], 50)
    assert (rows[:, :40] >= 0).all() and (rows[:, 40:] == -1).all()
    assert np.isinf(d[:, 40:]).all()


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def blob_index():
    """tests/test_index.py's index: 1,500 x 12 blobs, the reference's
    build; (permuted data, tree)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 12)).astype(np.float32) * 8
    lab = rng.integers(0, 6, 1500)
    x = (centers[lab] + rng.normal(size=(1500, 12))).astype(np.float32)
    tree, perm, _ = jidx.build_index(x, min_leaf=16, max_leaf=256,
                                     dpc_max_clusters=6)
    return x[perm], tree


@pytest.mark.parametrize("tie_break", [False, True])
def test_reorder_siblings_matches_reference(blob_index, tie_break):
    """From identical counts (seeded, with many ties), the same child
    lists and the same number changed; the tie-break cost is a skewed
    workload's total nodes scanned through each package's host
    executor, and no query's rows change."""
    data, ref_tree = blob_index
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 4, ref_tree.n_nodes)
    qs = [(data[0] + rng.normal(size=data.shape[1]) * 0.5)
          .astype(np.float32) for _ in range(10)]
    out = []
    for pkg, reo in ((jidx, jreo), (tidx, treo)):
        tree = _tree_copy(ref_tree, pkg.ClusterTree)
        ex = pkg.HostExecutor(tree, data)
        before = [ex.knn(q, 5)[0] for q in qs]
        reo.reset_access_counts(tree)
        tree.access_count[:] = counts
        cost = None
        if tie_break:
            def cost(ex=ex):
                return sum(ex.knn(q, 5)[1].nodes_scanned for q in qs)
        changed = reo.reorder_siblings(tree, cost)
        for q, r0 in zip(qs, before):
            np.testing.assert_array_equal(ex.knn(q, 5)[0], r0)
        out.append((tree, changed))
    (jt, jc), (tt, tc) = out
    assert tc == jc > 0
    assert tt.children == jt.children
    np.testing.assert_array_equal(tt.access_count, jt.access_count)


@pytest.mark.parametrize("tie_break", [False, True])
def test_optimize_index_matches_reference(pair, tie_break):
    """``optimize_index`` on both platforms (the scalar path's counts):
    the same number changed, the same child lists and counts. The
    fixture's trees are restored afterwards."""
    p, pt = pair
    saved = [(x.tree.children, x.tree.access_count.copy()) for x in (p, pt)]
    try:
        wl = {}
        for M, plat in ((JQ, p), (TQ, pt)):
            t = plat.table
            wl[M] = [M.VK.of("img", t.vector["img"][i], 10)
                     for i in range(0, 40, 5)]
            wl[M] += [M.And.of(M.NR("price", 10, 40),
                               M.VK.of("img", t.vector["img"][i], 5))
                      for i in range(3)]
            plat.tree.children = [list(c) for c in plat.tree.children]
        jc = p.optimize_index(wl[JQ], tie_break=tie_break)
        tc = pt.optimize_index(wl[TQ], tie_break=tie_break)
        assert tc == jc > 0
        assert pt.tree.children == p.tree.children
        np.testing.assert_array_equal(pt.tree.access_count,
                                      p.tree.access_count)
    finally:
        for x, (ch, ac) in zip((p, pt), saved):
            x.tree.children, x.tree.access_count[:] = ch, ac


# ---------------------------------------------------------------------------
# MQRLD.execute (the scalar path)
# ---------------------------------------------------------------------------
FORMS = list(_forms(TQ, type("P", (), {"table": _table(TTable)})).keys())


@pytest.mark.parametrize("form", FORMS)
def test_execute_matches_reference(pair, form):
    """Rows in the reference's order, ``QueryStats`` but its time, and the
    access counts; and the rows are the oracle's."""
    p, pt = pair
    jq, tq = _forms(JQ, p)[form], _forms(TQ, pt)[form]
    p.tree.access_count[:] = 0
    pt.tree.access_count[:] = 0
    jr, js = p.execute(jq, record=False)
    tr, ts = pt.execute(tq, record=False)
    np.testing.assert_array_equal(tr, jr)
    for key in STATS:
        assert getattr(ts, key) == getattr(js, key), key
    np.testing.assert_array_equal(pt.tree.access_count, p.tree.access_count)
    if isinstance(tq, TQ.VK):
        np.testing.assert_array_equal(tr, pt.oracle(tq))
    else:
        np.testing.assert_array_equal(np.sort(tr), pt.oracle(tq))


def test_execute_records_the_same_qbs_rows(pair):
    """Sampled at 0.5 from seed 0, both packages record the same rows
    (every field but the times) and workload signatures; with the wall
    times set equal, the same S1 and objectives, overall and per task."""
    p, pt = pair
    jt, tt = jqbs.QBSTable(0.5, 0), tqbs.QBSTable(0.5, 0)
    old = p.qbs, pt.qbs
    p.qbs, pt.qbs = jt, tt
    try:
        jf, tf = _forms(JQ, p), _forms(TQ, pt)
        for i, name in enumerate(FORMS * 2):
            task = "ab"[i % 2]
            p.execute(jf[name], task=task)
            pt.execute(tf[name], task=task)
    finally:
        p.qbs, pt.qbs = old
    assert 0 < len(tt) == len(jt) < 2 * len(FORMS)
    for a, b in zip(tt.rows, jt.rows):
        for f in ROW_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        a.query_time_s = b.query_time_s
    assert tt.mix == jt.mix
    assert tt.extrinsic_score() == jt.extrinsic_score()
    assert tt.extrinsic_score("b") == jt.extrinsic_score("b")
    assert tt.objectives() == jt.objectives()
    assert tt.per_task() == jt.per_task()
    assert tt.objectives("none") == jt.objectives("none")
    assert tt.extrinsic_score("none") == jt.extrinsic_score("none") == 0.0


def test_platform_takes_qbs_sample_and_seed():
    t = _table(TTable)
    pt = MQRLD(t, qbs_sample=0.25, seed=3, device="cpu")
    want = np.random.default_rng(3).random(8) <= 0.25
    got = [pt.qbs.maybe_record(
        statement="", object_set="", attributes=[], types=[],
        recall_at_k=1, cbr=0, query_time_s=0, accuracy=1) is not None
        for _ in range(8)]
    assert got == want.tolist()


def test_qbs_row_ring_is_bounded():
    t = tqbs.QBSTable()
    for i in range(tqbs._ROWS_KEEP + 5):
        t.record(statement=str(i), object_set="", attributes=[], types=[],
                 recall_at_k=1, cbr=0, query_time_s=0, accuracy=1)
    assert len(t) == tqbs._ROWS_KEEP
    assert t.rows[0].statement == "5"


@pytest.mark.parametrize("res,truth,k", [
    ([1, 2, 3], [1, 2, 9], None), ([1, 2], [1, 2], 0), ([], [], None),
    ([1], [2], 1), ([5, 6, 7], [7, 6, 5, 4], 2)])
def test_recall_and_accuracy_match_reference(res, truth, k):
    assert tqbs.recall_at_k(res, truth, k) == jqbs.recall_at_k(res, truth, k)
    assert tqbs.accuracy(res, truth) == jqbs.accuracy(res, truth)


# ---------------------------------------------------------------------------
# The planner's scalar fallback
# ---------------------------------------------------------------------------
def test_planner_fallback_matches_reference(pair):
    """tests/test_query_platform.py::test_explain_structure's batch: the
    same paths and explain() fragments, the unplannable query through
    the scalar path, every row the oracle's and the reference's."""
    p, pt = pair

    def batch(M, t):
        v = t.vector["img"][17]
        return [M.And.of(M.NR("price", 10, 60), M.VK.of("img", v, 6)),
                M.VR.of("img", v, 3.0),
                M.And.of(M.Or.of(M.VK.of("img", v, 4), M.NR("price", 0, 1)),
                         M.NR("price", 0, 60))]
    jb, tb = batch(JQ, p.table), batch(TQ, pt.table)
    jplan = JSession(p, interpret=True).plan(jb)
    tplan = pt.session().plan(tb)
    je, te = jplan.explain(), tplan.explain()
    for key in ("n_queries", "n_engine", "n_scalar", "knn_groups"):
        assert te[key] == je[key], key
    assert te["n_scalar"] == 1
    for a, b in zip(te["fragments"], je["fragments"]):
        assert a["path"] == b["path"] and a["query"] == b["query"]
        for ka, kb in zip(a["knn"], b["knn"]):
            for f in ("attr", "k", "masked", "group", "archetype",
                      "beam_seed"):
                assert ka[f] == kb[f], f
        for va, vb in zip(a["vr"], b["vr"]):
            for f in ("tiles_surviving", "tiles_pruned", "tiles_total"):
                assert va[f] == vb[f], f
            assert va["cost"]["route"] == vb["cost"]["route"]
    assert [f["path"] for f in te["fragments"]] == \
        ["device-loop", "device-loop", "scalar"]
    got, st = tplan.execute()
    want, _ = jplan.execute()
    assert st.queries == 3
    for q, a, b in zip(tb, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(a), np.sort(pt.oracle(q)))


# ---------------------------------------------------------------------------
# measurement (§5.1.2)
# ---------------------------------------------------------------------------
def _blobs(n=400, d=8, k=4, spread=6.0, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, n)
    return (c[lab] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,k", [(300, 4), (1200, 5)])
def test_kmeans_and_silhouette_match_reference(n, k):
    x = _blobs(n=n, k=k)
    jl, jc = jmeas.kmeans(x, k, seed=1)
    tl, tc = tmeas.kmeans(x, k, seed=1)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert abs(tmeas.silhouette(x, tl, sample=256) -
               jmeas.silhouette(x, jl, sample=256)) <= 1e-12
    assert abs(tmeas.sc_score(x, k=k) - jmeas.sc_score(x, k=k)) <= 1e-12


def test_blocked_distances_match_reference():
    x, c = _blobs(n=5000), _blobs(n=7, seed=1)
    np.testing.assert_array_equal(tmeas._blocked_d2(x, c, block=1024),
                                  jmeas._blocked_d2(x, c, block=1024))


def test_fidelity_and_frechet_match_reference():
    x = _blobs(n=400, d=10)
    rng = np.random.default_rng(1)
    for emb in (x.copy(), rng.normal(size=(400, 10)).astype(np.float32),
                x[:, :4] * 2.0):
        assert abs(tmeas.fidelity_score(x, emb)
                   - jmeas.fidelity_score(x, emb)) <= 1e-12
    m1, c1 = tmeas.gaussian_moments(x)
    m2, c2 = tmeas.gaussian_moments(x[:, ::-1] * 1.5)
    jm1, jc1 = jmeas.gaussian_moments(x)
    np.testing.assert_array_equal(m1, jm1)
    np.testing.assert_array_equal(c1, jc1)
    assert abs(tmeas.frechet_distance(m1, c1, m2, c2)
               - jmeas.frechet_distance(m1, c1, m2, c2)) <= 1e-12


def test_select_model_matches_reference():
    x = _blobs(n=500, d=10, spread=8.0)
    rng = np.random.default_rng(2)
    embs = {"good": x + 0.01 * rng.normal(size=x.shape).astype(np.float32),
            "noise": rng.normal(size=(500, 10)).astype(np.float32),
            "half": x[:, :5].copy()}
    ext = {"good": 0.2, "noise": 0.9, "half": 0.5}
    js = jmeas.measure_models(x, embs, extrinsic=ext, k=4, sample=300)
    ts = tmeas.measure_models(x, embs, extrinsic=ext, k=4, sample=300)
    for a, b in zip(ts, js):
        assert a.model == b.model and a.s1 == b.s1
        assert abs(a.s2 - b.s2) <= 1e-12 and abs(a.s3 - b.s3) <= 1e-12
    for method in ("SC", "IN", "IN+EX"):
        assert tmeas.select_model(ts, method).model == \
            jmeas.select_model(js, method).model
    assert tmeas.select_model(ts, "IN").model == "good"
