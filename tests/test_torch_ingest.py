"""Ingest in the port: appends unioned into every query path, and fold.

Two parts.

* The reference's ``tests/test_ingest.py`` on the port's own platform:
  after any interleaving of ``append`` / ``plan().execute()`` / ``fold``,
  every result on the scalar path and both beam loops equals the
  brute-force oracle over base + delta (``MQRLD.view()``); appends
  validate before they change anything, the auto-fold fires past its
  ratio, a fold keeps each query's logical rows and the tree's balls,
  plans stay warm across appends and go cold at a fold, and
  ``explain()`` reports the delta. The fuzz takes the reference's
  save/load step too (``core.persist``, the live delta must survive).
* Parity with the reference: the reference ``MQRLD`` (its Pallas top-k in
  interpret mode, its default on the CPU) and the port on the carried
  state take the same seeded appends, then a fold. After each, every
  query's rows on the scalar path and on both beam loops in fp32, int8
  and bf16 equal the reference's exactly, and the oracle's; the
  ``explain()`` delta blocks are equal; and the folded trees, layouts
  and enhanced features are equal array for array (the fold's walk,
  splice and fits are host numpy on both sides).
"""
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import query as JQ
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro_torch.core import query as Q
from repro_torch.core.engine import plannable
from repro_torch.core.lake import MMOTable
from repro_torch.core.persist import load_platform, save_platform
from repro_torch.core.platform import MQRLD, state_from_numpy
from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)

_KS = (1, 5, 17)


def _table(M, seed=0, n=500):
    """The reference test's table: 5-centre ``img`` (8-d), Gaussian
    ``audio`` (5-d), uniform ``price`` and integer ``stock``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 5
    lab = rng.integers(0, 5, n)
    img = (centers[lab] + rng.normal(size=(n, 8))).astype(np.float32)
    audio = rng.normal(size=(n, 5)).astype(np.float32) * 2
    t = (M("ingest")
         .add_vector("img", img)
         .add_vector("audio", audio)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32))
         .add_numeric("stock", rng.integers(0, 50, n).astype(np.float32)))
    return t, centers


def _make_platform(seed=0, n=500):
    t, centers = _table(MMOTable, seed, n)
    p = MQRLD(t, seed=seed, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p, centers


def _rand_rows(rng, centers, m):
    lab = rng.integers(0, 5, m)
    return {
        "numeric": {"price": rng.uniform(0, 100, m).astype(np.float32),
                    "stock": rng.integers(0, 50, m).astype(np.float32)},
        "vector": {"img": (centers[lab]
                           + rng.normal(size=(m, 8))).astype(np.float32),
                   "audio": rng.normal(size=(m, 5)).astype(np.float32) * 2},
    }


def _rand_basic(rng, tab):
    kind = rng.integers(0, 4)
    if kind == 0:
        attr = ("price", "stock")[rng.integers(0, 2)]
        col = tab.numeric[attr]
        v = float(col[rng.integers(0, len(col))])
        return Q.NE(attr, v, float(rng.choice([1e-6, 0.5, 5.0])))
    if kind == 1:
        attr = ("price", "stock")[rng.integers(0, 2)]
        lo = float(rng.uniform(-10, 100))
        return Q.NR(attr, lo, lo + float(rng.uniform(0, 60)))
    attr = ("img", "audio")[rng.integers(0, 2)]
    col = tab.vector[attr]
    base = col[rng.integers(0, len(col))]
    v = base + rng.normal(size=col.shape[1]).astype(np.float32) \
        * float(rng.uniform(0, 0.5))
    if kind == 2:
        anchor = col[rng.integers(0, len(col))]
        r = float(np.sqrt(((anchor - v) ** 2).sum()) * rng.uniform(0.3, 1.5))
        return Q.VR.of(attr, v, max(r, 1e-3))
    return Q.VK.of(attr, v, int(rng.choice(_KS)))


def _rand_query(rng, tab, depth=2):
    if depth == 0 or rng.random() < 0.5:
        return _rand_basic(rng, tab)
    parts = tuple(_rand_query(rng, tab, depth - 1)
                  for _ in range(rng.integers(2, 4)))
    return Q.And(parts) if rng.random() < 0.5 else Q.Or(parts)


def _rowset(rows):
    return set(np.asarray(rows).tolist())


def _check_batch(p, sess, rng, batch_size=3):
    """One random hybrid batch through the planned path, both loops,
    against brute force over the current base + delta view (unplannable
    trees against the scalar path)."""
    view = p.view()
    batch = [_rand_query(rng, view) for _ in range(batch_size)]
    truth = [Q.execute_bruteforce(view, Q.normalize(q)) if plannable(q)
             else p.execute(q, record=False)[0] for q in batch]
    for dl in (True, False):
        got, _ = sess.plan(batch, device_loop=dl).execute()
        for q, rows, want in zip(batch, got, truth):
            assert _rowset(rows) == _rowset(want), (dl, p.n_delta, q)


# ---------------------------------------------------------------------------
# The interleaved ingest/query fuzz
# ---------------------------------------------------------------------------
def _fuzz_session(seed, steps=25):
    """append / query / fold / save+load interleaved, oracle-checked after
    every step."""
    p, centers = _make_platform(seed=3)
    sess = p.session()
    rng = np.random.default_rng(5000 + seed)
    with tempfile.TemporaryDirectory() as tmpdir:
        for _ in range(steps):
            op = rng.random()
            if op < 0.45:
                rows = _rand_rows(rng, centers, int(rng.integers(1, 8)))
                p.append(numeric=rows["numeric"], vector=rows["vector"],
                         fold=False)
            elif op < 0.55 and p.n_delta:
                p.fold()
            elif op < 0.62:
                save_platform(p, tmpdir)
                nd = p.n_delta
                p = load_platform(tmpdir, device="cpu")
                sess = p.session()
                assert p.n_delta == nd  # the delta survived the round trip
            _check_batch(p, sess, rng)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_interleaved_ingest_query(seed):
    """8 seeds x 25 interleaved steps, every step oracle-checked on both
    beam loops."""
    _fuzz_session(seed)


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_property_interleaved_ingest(seed):
    _fuzz_session(seed % 997, steps=6)


# ---------------------------------------------------------------------------
# Append basics
# ---------------------------------------------------------------------------
def test_append_visible_to_all_paths_immediately():
    p, centers = _make_platform(seed=1)
    nb = p.table.n_rows
    rng = np.random.default_rng(9)
    rows = _rand_rows(rng, centers, 6)
    # one appended row right on top of an existing vector must show up
    # in that vector's KNN
    rows["vector"]["img"][0] = p.table.vector["img"][17] + 1e-3
    assert p.append(numeric=rows["numeric"], vector=rows["vector"],
                    fold=False) == 6
    q = Q.VK.of("img", p.table.vector["img"][17], 3)
    want = _rowset(p.oracle(q))
    scalar, _ = p.execute(q, record=False)
    assert _rowset(scalar) == want
    for dl in (True, False):
        (got,), _ = p.execute_batch([q], device_loop=dl)
        assert _rowset(got) == want, dl
    assert any(r >= nb for r in want), "delta row should be a neighbor"


def test_append_validates_before_mutating():
    p, centers = _make_platform(seed=2)
    rng = np.random.default_rng(3)
    rows = _rand_rows(rng, centers, 3)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    epoch = p.delta_epoch
    with pytest.raises(ValueError):
        p.append(numeric={"price": [1.0]}, vector={}, fold=False)
    with pytest.raises(ValueError):
        bad = _rand_rows(rng, centers, 2)
        bad["vector"]["img"] = bad["vector"]["img"][:, :4]  # wrong dim
        p.append(numeric=bad["numeric"], vector=bad["vector"], fold=False)
    assert p.n_delta == 3 and p.delta_epoch == epoch  # untouched


def test_first_append_that_fails_leaves_no_delta():
    """A failed first append leaves no delta region behind: the view, the
    epoch and the engine's union stay the base's."""
    p, centers = _make_platform(seed=2)
    with pytest.raises(ValueError):
        p.append(numeric={"price": [1.0]}, vector={}, fold=False)
    assert p.delta is None and p.delta_epoch == 0
    assert p.view() is p.table and p.engine().delta_tiles == 0


def test_auto_fold_past_ratio():
    p, centers = _make_platform(seed=4, n=300)
    p.auto_fold_ratio = 0.1
    rng = np.random.default_rng(4)
    rows = _rand_rows(rng, centers, 10)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    assert p.n_delta == 10
    build0 = p.build_id
    rows = _rand_rows(rng, centers, 25)  # 35 > 0.1 * 300
    left = p.append(numeric=rows["numeric"], vector=rows["vector"])
    assert left == 0 and p.n_delta == 0
    assert p.build_id == build0 + 1  # fold bumped it
    assert p.table.n_rows == 335


def test_background_fold_mode_marks_fold_due():
    """Under ``fold_mode = "background"`` the auto-fold trigger only
    marks ``fold_due``; a fold clears it."""
    p, centers = _make_platform(seed=4, n=300)
    p.auto_fold_ratio = 0.1
    p.fold_mode = "background"
    rng = np.random.default_rng(4)
    rows = _rand_rows(rng, centers, 10)
    p.append(numeric=rows["numeric"], vector=rows["vector"])
    assert not p.fold_due
    rows = _rand_rows(rng, centers, 25)
    assert p.append(numeric=rows["numeric"], vector=rows["vector"]) == 35
    assert p.fold_due and p.table.n_rows == 300
    assert p.fold() == 35 and not p.fold_due


def test_prepare_merges_a_pending_delta():
    """``prepare()`` with a live delta rebuilds over base + delta."""
    p, centers = _make_platform(seed=5, n=300)
    rng = np.random.default_rng(5)
    rows = _rand_rows(rng, centers, 12)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    epoch = p.delta_epoch
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    assert p.n_delta == 0 and p.delta_epoch == epoch + 1
    assert p.table.n_rows == p.raw_table.n_rows == 312
    q = Q.VK.of("img", rows["vector"]["img"][3], 5)
    np.testing.assert_array_equal(p.execute_batch([q])[0][0], p.oracle(q))


def test_fold_preserves_logical_rows():
    """Folding re-lays the physical order; the LOGICAL result set of a
    query (by row_ids) must be identical before and after."""
    p, centers = _make_platform(seed=5)
    rng = np.random.default_rng(6)
    rows = _rand_rows(rng, centers, 12)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    q = Q.And.of(Q.NR("price", 10, 90),
                 Q.VK.of("img", p.table.vector["img"][5], 9))
    before, _ = p.execute(q, record=False)
    ids_before = set(p.view().row_ids[before].tolist())
    folded = p.fold()
    assert folded == 12 and p.n_delta == 0
    after, _ = p.execute(q, record=False)
    assert set(p.table.row_ids[after].tolist()) == ids_before
    for dl in (True, False):
        (got,), _ = p.execute_batch([q], device_loop=dl)
        assert _rowset(got) == _rowset(after), dl


def test_fold_keeps_tree_ball_invariant():
    """fold() widens leaf and ancestor radii so the enhanced-space tree
    stays a correct bounding hierarchy for every inserted row."""
    p, centers = _make_platform(seed=6)
    rng = np.random.default_rng(7)
    rows = _rand_rows(rng, centers, 20)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    p.fold()
    tree = p.tree
    for lid in tree.leaf_ids:
        s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
        node = int(lid)
        while node >= 0:
            d = np.sqrt(((p.enhanced[s:e] - tree.centroid[node]) ** 2)
                        .sum(1))
            assert (d <= tree.radius[node] + 1e-3).all(), node
            node = int(tree.parent[node])


def test_union_rerank_scales_cover_the_delta():
    """The certified re-rank's error scales (a port decision the
    reference does not have) cover the union: rows appended far from the
    origin raise ``vec_max2`` and each layout's ``cen_max2`` and
    ``rad_max`` to at least the delta tiles' own, and the rows stay the
    oracle's; an empty delta brings back the base's scales."""
    p, centers = _make_platform(seed=10)
    eng = p.engine()
    base = (dict(eng.vec_max2), eng.geom["img"].cen_max2,
            eng.geom_dev["img"].rad_max)
    rng = np.random.default_rng(13)
    rows = _rand_rows(rng, centers, 40)
    rows["vector"]["img"] = rows["vector"]["img"] * 4 + 30
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    eng = p.engine()
    new = rows["vector"]["img"].astype(np.float64)
    assert eng.vec_max2["img"] >= (new ** 2).sum(1).max() > base[0]["img"]
    for geom in (eng.geom["img"], eng.geom_dev["img"]):
        t = eng.delta_tiles if geom is eng.geom["img"] else \
            geom.n_leaves - eng._base["geom_dev"]["img"].n_leaves
        cen = geom.centroid[-t:].double()
        assert geom.cen_max2 >= float((cen ** 2).sum(1).max()) > base[1]
        assert geom.rad_max >= float(geom.radius[-t:].max())
    qs = [Q.VK.of("img", p.view().vector["img"][i], 17)
          for i in (0, 500, 520)]
    for dl in (True, False):
        got, _ = p.session().plan(qs, device_loop=dl).execute()
        for q, g in zip(qs, got):
            np.testing.assert_array_equal(g, p.oracle(q))
    p.fold()
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    p.delta.clear()
    p.delta_epoch += 1
    eng = p.engine()
    assert eng.delta_tiles == 0 and eng.n == p.n_base


# ---------------------------------------------------------------------------
# Plan-cache semantics under writes
# ---------------------------------------------------------------------------
def test_plan_cache_warm_across_append_invalidated_by_fold():
    p, centers = _make_platform(seed=7)
    sess = p.session()
    rng = np.random.default_rng(8)
    batch = [Q.And.of(Q.NR("price", 20, 80),
                      Q.VK.of("img", p.table.vector["img"][3], 5)),
             Q.VR.of("img", p.table.vector["img"][9], 3.0)]
    pl = sess.plan(batch)
    assert not pl.cache_hit
    pl.execute()
    rows = _rand_rows(rng, centers, 5)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    pl2 = sess.plan(batch)
    assert pl2.cache_hit, "append must NOT invalidate cached plans"
    got, _ = pl2.execute()  # but execution must see the delta
    for q, r in zip(batch, got):
        assert _rowset(r) == _rowset(p.oracle(q)), q
    p.fold()
    pl3 = sess.plan(batch)
    assert not pl3.cache_hit, "fold bumps build_id -> plans invalidate"
    got, _ = pl3.execute()
    for q, r in zip(batch, got):
        assert _rowset(r) == _rowset(p.oracle(q)), q


def test_explain_reports_delta_state():
    """The explain() delta block: epoch, live rows and union tile count,
    read at explain time (not baked at plan time)."""
    p, centers = _make_platform(seed=8)
    sess = p.session()
    batch = [Q.VK.of("img", p.table.vector["img"][2], 5)]
    pl = sess.plan(batch)
    ex0 = pl.explain()
    assert ex0["delta"] == {"epoch": 0, "rows": 0, "tiles": 0}
    rng = np.random.default_rng(11)
    rows = _rand_rows(rng, centers, 7)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    ex1 = pl.explain()  # SAME plan object: delta read at explain time
    assert ex1["delta"]["rows"] == 7
    assert ex1["delta"]["epoch"] == p.delta_epoch
    assert ex1["delta"]["tiles"] >= 1
    assert set(ex1["delta"]) == {"epoch", "rows", "tiles"}
    assert ex1["knn_groups"][0]["archetype"].endswith(":delta")
    p.fold()
    ex2 = sess.plan(batch).explain()
    assert ex2["delta"]["rows"] == 0 and ex2["delta"]["tiles"] == 0
    assert ex2["build_id"] == ex1["build_id"] + 1
    assert not ex2["knn_groups"][0]["archetype"].endswith(":delta")


def test_delta_widths_keyed_apart_from_base():
    """Convergence widths recorded while the delta is unioned in carry
    the ``:delta`` suffix; after the fold they key on the base
    archetype again."""
    p, centers = _make_platform(seed=9)
    sess = p.session()
    rng = np.random.default_rng(12)
    rows = _rand_rows(rng, centers, 9)
    p.append(numeric=rows["numeric"], vector=rows["vector"], fold=False)
    batch = [Q.VK.of("img", p.view().vector["img"][i], 5)
             for i in (1, 100, 505)]
    _, st = sess.plan(batch).execute()
    assert st.knn_group_widths and all(
        a.endswith(":delta") for a, _ in st.knn_group_widths)
    p.fold()
    _, st = sess.plan(batch).execute()
    assert not any(a.endswith(":delta") for a, _ in st.knn_group_widths)


# ---------------------------------------------------------------------------
# Parity with the reference on the carried state
# ---------------------------------------------------------------------------
PRECISIONS = ("fp32", "int8", "bf16")
CHECKPOINTS = ("append 9", "append 5", "fold")
PATHS = ("scalar",) + tuple(f"{'device' if dl else 'host'}-{prec}"
                            for prec in PRECISIONS for dl in (True, False))


def _parity_batch(M, view, nb):
    """Four archetypes around a base row, another base row and two delta
    rows: V.K, filtered V.K, V.R with a numeric range, V.R with V.K on
    the second vector attribute; an N.E and an Or."""
    out = []
    for i in (3, 250, nb + 1, nb + 5):
        x, a = view.vector["img"][i], view.vector["audio"][i]
        out += [M.VK.of("img", x, 5),
                M.And.of(M.NR("price", 20, 80), M.VK.of("img", x, 7)),
                M.And.of(M.VR.of("img", x, 3.0), M.NR("stock", 5, 40)),
                M.And.of(M.VR.of("audio", a, 2.5), M.VK.of("audio", a, 4))]
    out.append(M.NE("stock", float(view.numeric["stock"][nb + 2]), 0.5))
    out.append(M.Or.of(M.VR.of("audio", view.vector["audio"][nb], 1.5),
                       M.NR("price", 0, 3)))
    return out


@pytest.fixture(scope="module")
def ingest_parity():
    """Both packages through the same appends and fold; per checkpoint
    the rows of every path, the oracle's, and the explain() delta
    blocks, then the folded states."""
    t, centers = _table(JTable)
    jp = JMQRLD(t, seed=0)
    jp.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    nb = jp.table.n_rows
    pt = state_from_numpy(ref_state_arrays(jp), device="cpu")
    rng = np.random.default_rng(21)
    record = {}
    for cp in CHECKPOINTS:
        if cp == "fold":
            record["folded"] = (jp.fold(), pt.fold())
        else:
            rows = _rand_rows(rng, centers, int(cp.split()[1]))
            rows["vector"]["img"][0] = jp.table.vector["img"][3] + 1e-3
            for plat in (jp, pt):
                plat.append(numeric=rows["numeric"], vector=rows["vector"],
                            fold=False)
        view = pt.view()
        jb, tb = _parity_batch(JQ, view, nb), _parity_batch(Q, view, nb)
        got = {"scalar": ([jp.execute(q, record=False)[0] for q in jb],
                          [pt.execute(q, record=False)[0] for q in tb])}
        for prec in PRECISIONS:
            for dl in (True, False):
                want, _ = jp.session(precision=prec).plan(
                    jb, device_loop=dl).execute()
                mine, _ = pt.session(precision=prec).plan(
                    tb, device_loop=dl).execute()
                got[f"{'device' if dl else 'host'}-{prec}"] = (want, mine)
        record[cp] = dict(
            rows=got, oracle=[pt.oracle(q) for q in tb],
            ref_oracle=[jp.oracle(q) for q in jb], nb=nb,
            explain=(jp.session().plan(jb).explain()["delta"],
                     pt.session().plan(tb).explain()["delta"]))
    return jp, pt, record


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
def test_parity_rows(ingest_parity, checkpoint, path):
    """Each query's rows on this path equal the reference's and the
    oracle's, exactly; while the delta is live, an appended row answers
    the query placed 1e-3 from it."""
    _, _, record = ingest_parity
    rec = record[checkpoint]
    want, got = rec["rows"][path]
    for i, (w, g, o) in enumerate(zip(want, got, rec["oracle"])):
        if path == "scalar":       # the scalar path's V.K is unordered
            assert _rowset(g) == _rowset(w) == _rowset(o), i
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
            np.testing.assert_array_equal(g, o, err_msg=str(i))
        assert _rowset(o) == _rowset(rec["ref_oracle"][i]), i
    if checkpoint != "fold":
        assert rec["nb"] in got[0].tolist()


@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
def test_parity_explain_delta(ingest_parity, checkpoint):
    _, _, record = ingest_parity
    ref_delta, port_delta = record[checkpoint]["explain"]
    assert port_delta == ref_delta
    assert (port_delta["rows"] == 0) == (checkpoint == "fold")


def test_parity_folded_state(ingest_parity):
    """The folded trees, layouts, leaf metadata and enhanced features
    equal the reference's array for array."""
    jp, pt, record = ingest_parity
    assert record["folded"] == (14, 14)
    for k in ("bucket_start", "bucket_end", "radius", "lm_a", "lm_b",
              "centroid", "parent", "is_leaf"):
        np.testing.assert_array_equal(getattr(pt.tree, k),
                                      getattr(jp.tree, k), err_msg=k)
    np.testing.assert_array_equal(pt.table.row_ids, jp.table.row_ids)
    np.testing.assert_array_equal(pt.table.bucket_starts,
                                  jp.table.bucket_starts)
    np.testing.assert_array_equal(pt.enhanced, jp.enhanced)
    for k in jp.table.vector:
        np.testing.assert_array_equal(pt.table.vector[k], jp.table.vector[k])
    for k in jp.table.numeric:
        np.testing.assert_array_equal(pt.table.numeric[k],
                                      jp.table.numeric[k])
    for f in ("vec_centroid", "vec_radius", "num_lo", "num_hi"):
        for k, v in getattr(jp.meta, f).items():
            np.testing.assert_array_equal(getattr(pt.meta, f)[k], v)
    np.testing.assert_array_equal(pt.raw_table.vector["img"],
                                  jp.raw_table.vector["img"])
