"""Persistence in the port: snapshots that either package loads.

* The reference's ``tests/test_persist.py`` on the port, and the port's
  counterparts of the reference's persistence tests elsewhere (the cost
  model in the snapshot, the int8 default's planes, the QBS convergence
  rings, the lake directory, a live delta and a column subset across a
  save and load).
* Both directions: the reference saves and the port loads, and the port
  saves and the reference loads. After each load the tree (children
  order and access counts included), enhanced features, transform,
  layout, QBS rows and rings, cost model, defaults and live delta equal
  the saver's, and every query's rows on the scalar path and on both
  loops in fp32, int8 and bf16 equal the saver's exactly.
* The int8 planes in ``quant.npz`` are taken by the loader's engine,
  shown by a count of ``plan_tiles`` calls (none) and by the engine's
  planes sharing memory with the loaded arrays, in both directions.
* The generation layout: ``CURRENT`` flips, two generations retained, a
  save that raises midway leaves the old generation serving, and
  ``rollback_platform`` (fresh and ``into=``) and ``MQRLD.rollback()``.
"""
import copy
import json
import os
import tempfile
from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.utils.quant as jquant
from repro.core import persist as jpersist
from repro.core import query as JQ
from repro.core.cost import CostModel as JCostModel
from repro.core.engine import HybridEngine as JEngine
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro.core.qbs import QBSTable as JQBSTable
from repro_torch.core import cost as costm
from repro_torch.core import persist as tpersist
from repro_torch.core import query as Q
from repro_torch.core.engine import HybridEngine
from repro_torch.core.lake import DataLake, MMOTable
from repro_torch.core.persist import (_resolve_snapshot, current_generation,
                                      list_generations, load_platform,
                                      rollback_platform, save_platform)
from repro_torch.core.platform import MQRLD
from repro_torch.core.qbs import _ROWS_KEEP, QBSTable
from repro_torch.utils import quant as tquant

torch.set_num_threads(1)

PRECISIONS = ("fp32", "int8", "bf16")
PATHS = ("scalar",) + tuple(f"{'device' if dl else 'host'}-{prec}"
                            for prec in PRECISIONS for dl in (True, False))
TREE_FIELDS = ("centroid", "radius", "parent", "is_leaf", "bucket_start",
               "bucket_end", "lm_a", "lm_b", "depth", "access_count")


def _table(M, seed=0, n=500):
    """The reference ingest tests' table: 5-centre ``img`` (8-d),
    Gaussian ``audio`` (5-d), uniform ``price``, integer ``stock`` and a
    raw URI per row."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 5
    lab = rng.integers(0, 5, n)
    img = (centers[lab] + rng.normal(size=(n, 8))).astype(np.float32)
    audio = rng.normal(size=(n, 5)).astype(np.float32) * 2
    t = (M("persist")
         .add_vector("img", img)
         .add_vector("audio", audio)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32))
         .add_numeric("stock", rng.integers(0, 50, n).astype(np.float32))
         .with_raw([f"u://{i}" for i in range(n)]))
    return t, centers


def _rows(rng, centers, m):
    lab = rng.integers(0, 5, m)
    return dict(
        numeric={"price": rng.uniform(0, 100, m).astype(np.float32),
                 "stock": rng.integers(0, 50, m).astype(np.float32)},
        vector={"img": (centers[lab]
                        + rng.normal(size=(m, 8))).astype(np.float32),
                "audio": rng.normal(size=(m, 5)).astype(np.float32) * 2},
        raw_uri=[f"d://{i}" for i in range(m)])


def _queries(M, view, nb):
    """V.K, filtered V.K, V.R with a range, V.R with V.K on the second
    attribute around a base row and a delta row; an N.E and an Or."""
    out = []
    for i in (3, nb + 1):
        x, a = view.vector["img"][i], view.vector["audio"][i]
        out += [M.VK.of("img", x, 5),
                M.And.of(M.NR("price", 20, 80), M.VK.of("img", x, 7)),
                M.And.of(M.VR.of("img", x, 3.0), M.NR("stock", 5, 40)),
                M.And.of(M.VR.of("audio", a, 2.5), M.VK.of("audio", a, 4))]
    out.append(M.NE("stock", float(view.numeric["stock"][nb + 2]), 0.5))
    out.append(M.Or.of(M.VR.of("audio", view.vector["audio"][nb], 1.5),
                       M.NR("price", 0, 3)))
    return out


def _fill(p, M, cost_cls, rng, centers):
    """Give a prepared platform every piece of state a snapshot carries:
    QBS rows (scalar path, recorded), convergence and workload rings (a
    planned batch), latencies, cost samples and a fitted cost model, an
    int8 default with its engine's planes, and a live delta of 7 rows."""
    view = p.table
    for i in (3, 40, 77):
        p.execute(M.And.of(M.NR("price", 10, 90),
                           M.VK.of("img", view.vector["img"][i], 6)),
                  task="t")
    p.session().plan([M.VK.of("img", view.vector["img"][i], 5)
                      for i in (1, 2, 3)]).execute()
    p.qbs.record_latency("VK:img:k5:global", 0.01, n=3)
    for j in range(10):
        p.qbs.record_cost("knn:host", [1.0 + j] * costm.KNN_FEATURE_DIM,
                          0.01 * (j + 1))
        p.qbs.record_cost("vr:tile", [2.0 + j] * costm.VR_FEATURE_DIM,
                          0.02 * (j + 1))
    p.cost_model = cost_cls()
    p.cost_model.fit_from_qbs(p.qbs)
    p.default_precision = "int8"
    p.engine()                 # quantizes the base layouts under the default
    r = _rows(rng, centers, 7)
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)


def _state(p) -> dict:
    """Everything a snapshot must carry, as plain values (copies: later
    executions append to the live rings)."""
    t = p.tree
    out = {f"tree/{k}": np.asarray(getattr(t, k)) for k in TREE_FIELDS}
    out["tree/children"] = [list(map(int, c)) for c in t.children]
    out["enhanced"] = np.asarray(p.enhanced)
    for k in ("r", "s", "mean"):
        out[f"transform/{k}"] = np.asarray(getattr(p.transform, k))
    out["layout"] = {c: tuple(map(int, s)) for c, s in p.layout.items()}
    out["layout_order"] = list(p.layout)
    q = p.qbs
    out["qbs/rows"] = [asdict(r) for r in q.rows]
    out["qbs/convergence"] = q.convergence
    out["qbs/latency"] = q.latency
    out["qbs/cost"] = q.cost
    out["qbs/cost_total"] = q.cost_total
    out["cost_model"] = p.cost_model.to_dict()
    out["defaults"] = (p.default_precision, p.default_shards)
    for k, v in p.table.numeric.items():
        out[f"table/num/{k}"] = v
    for k, v in p.table.vector.items():
        out[f"table/vec/{k}"] = v
    out["table/row_ids"] = np.asarray(p.table.row_ids)
    out["table/raw_uri"] = list(p.table.raw_uri)
    d = p.delta
    for k in d.numeric_keys:
        out[f"delta/num/{k}"] = d.live_numeric(k)
    for k in d.vector_dims:
        out[f"delta/vec/{k}"] = d.live_vector(k)
    out["delta/raw_uri"] = list(d.raw_uri)
    return copy.deepcopy(out)


def _assert_state_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def _run_paths(p, M):
    """Every query's rows on each path (``PATHS``)."""
    view = p.view()
    qs = _queries(M, view, p.n_base)
    out = {"scalar": [p.execute(q, record=False)[0] for q in qs]}
    for prec in PRECISIONS:
        for dl in (True, False):
            rows, _ = p.session(precision=prec).plan(
                qs, device_loop=dl).execute()
            out[f"{'device' if dl else 'host'}-{prec}"] = rows
    return out, [p.oracle(q) for q in qs]


@pytest.fixture(scope="module")
def ref_to_port(tmp_path_factory):
    """The reference saves its filled platform; the port loads it. The
    state is read right after the load, before anything executes."""
    t, centers = _table(JTable)
    jp = JMQRLD(t, seed=0)
    jp.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    _fill(jp, JQ, JCostModel, np.random.default_rng(5), centers)
    d = str(tmp_path_factory.mktemp("ref_snapshot"))
    jpersist.save_platform(jp, d)
    want = _state(jp)
    pt = load_platform(d, device="cpu")
    got = _state(pt)
    return dict(saver=jp, loader=pt, dir=d, want=want, got=got,
                saver_rows=_run_paths(jp, JQ),
                loader_rows=_run_paths(pt, Q))


@pytest.fixture(scope="module")
def port_to_ref(tmp_path_factory):
    """The port prepares and fills its own platform and saves it; the
    reference loads it."""
    t, centers = _table(MMOTable, seed=1)
    pt = MQRLD(t, seed=0, device="cpu")
    pt.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    _fill(pt, Q, costm.CostModel, np.random.default_rng(6), centers)
    d = str(tmp_path_factory.mktemp("port_snapshot"))
    save_platform(pt, d)
    want = _state(pt)
    jp = jpersist.load_platform(d)
    got = _state(jp)
    return dict(saver=pt, loader=jp, dir=d, want=want, got=got,
                saver_rows=_run_paths(pt, Q),
                loader_rows=_run_paths(jp, JQ))


DIRECTIONS = ("ref_to_port", "port_to_ref")


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_snapshot_state_crosses(direction, request):
    rec = request.getfixturevalue(direction)
    _assert_state_equal(rec["got"], rec["want"])
    assert rec["loader"].n_delta == 7
    assert rec["loader"]._quant_cache["precision"] == "int8"
    assert current_generation(rec["dir"]) == rec["saver"].generation


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_snapshot_rows_cross(direction, path, request):
    """Each query's rows on the loaded platform equal the saver's on the
    same path, and the oracle's."""
    rec = request.getfixturevalue(direction)
    want, oracle = rec["saver_rows"]
    got, _ = rec["loader_rows"]
    for i, (w, g, o) in enumerate(zip(want[path], got[path], oracle)):
        if path == "scalar":          # the scalar path's V.K is unordered
            assert set(g.tolist()) == set(w.tolist()) == set(o.tolist()), i
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))
            np.testing.assert_array_equal(g, o, err_msg=str(i))
    # the live delta answers: the query around delta row nb + 1
    assert rec["saver"].n_base + 1 in got["device-fp32"][4].tolist()


def _count_plan_tiles(monkeypatch, module):
    calls = []
    real = module.plan_tiles

    def counted(tiles, valid, precision):
        calls.append(np.asarray(tiles).shape)
        return real(tiles, valid, precision)
    monkeypatch.setattr(module, "plan_tiles", counted)
    return calls


def test_port_engine_takes_reference_planes(ref_to_port, monkeypatch):
    """The port's int8 engine on the reference's snapshot quantizes
    nothing: its base planes are the loaded ``quant.npz`` arrays
    themselves. Without the cache it quantizes all four layouts."""
    pt = ref_to_port["loader"]
    cache = pt._quant_cache
    calls = _count_plan_tiles(monkeypatch, tquant)
    eng = HybridEngine(pt.tree, pt.table, pt.meta, precision="int8",
                       quant_cache=cache, device="cpu")
    assert calls == []
    for layout in ("host", "dev"):
        for attr in ("img", "audio"):
            got = eng._planes_np[(layout, attr)].data
            assert np.shares_memory(got, cache[f"{layout}__{attr}__data"])
    snap = eng.snapshot_planes()
    assert snap.keys() == {k for k in cache if k != "precision"}
    for k, v in snap.items():
        np.testing.assert_array_equal(v, cache[k], err_msg=k)
    HybridEngine(pt.tree, pt.table, pt.meta, precision="int8",
                 device="cpu")
    assert len(calls) == 4


def test_reference_engine_takes_port_planes(port_to_ref, monkeypatch):
    """The same the other way round: the reference's int8 engine on the
    port's snapshot takes its ``quant.npz`` as it is."""
    jp = port_to_ref["loader"]
    cache = jp._quant_cache
    calls = _count_plan_tiles(monkeypatch, jquant)
    eng = JEngine(jp.tree, jp.table, jp.meta, precision="int8",
                  quant_cache=cache)
    assert calls == []
    for layout in ("host", "dev"):
        for attr in ("img", "audio"):
            got = eng._planes_np[(layout, attr)].data
            assert np.shares_memory(got, cache[f"{layout}__{attr}__data"])
    JEngine(jp.tree, jp.table, jp.meta, precision="int8")
    assert len(calls) == 4


def test_port_planes_equal_reference_planes(port_to_ref):
    """The planes the port saved are the ones the reference quantizes
    from the same tiles, bit for bit."""
    jp = port_to_ref["loader"]
    mine = jp._quant_cache
    want = JEngine(jp.tree, jp.table, jp.meta,
                   precision="int8").snapshot_planes()
    assert want.keys() == {k for k in mine if k != "precision"}
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(v), mine[k], err_msg=k)


# ---------------------------------------------------------------------------
# The reference's tests/test_persist.py on the port
# ---------------------------------------------------------------------------
def test_platform_roundtrip_identical_answers():
    rng = np.random.default_rng(0)
    n, d = 1500, 10
    centers = rng.normal(size=(5, d)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 5, n)]
           + rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    t = (MMOTable("persist").add_vector("v", vec)
         .add_numeric("price", price)
         .with_raw([f"u://{i}" for i in range(n)]))
    p = MQRLD(t, seed=0, device="cpu")
    p.prepare(min_leaf=16, max_leaf=256)
    q = Q.And.of(Q.NR("price", 20, 70), Q.VK.of("v", vec[3], 8))
    rows0, _ = p.execute(q, task="t")

    with tempfile.TemporaryDirectory() as dd:
        save_platform(p, dd)
        p2 = load_platform(dd, device="cpu")
        # checked before executing (execution counts accesses)
        assert p2.tree.n_nodes == p.tree.n_nodes
        assert [c for c in p2.tree.children] == [c for c in p.tree.children]
        np.testing.assert_array_equal(p2.tree.access_count,
                                      p.tree.access_count)
        rows1, _ = p2.execute(q, record=False)
        assert sorted(rows1.tolist()) == sorted(rows0.tolist())
        assert len(p2.qbs) == len(p.qbs)
        d5 = p2.table.concat_features()[0][:5]
        back = p2.transform.inverse(p2.transform.apply(d5))
        np.testing.assert_allclose(back, d5, atol=1e-3)
        assert p2.table.get_mmos(rows1[:1])[0]["raw_uri"].startswith("u://")


# ---------------------------------------------------------------------------
# Counterparts of the reference's persistence tests in other files
# ---------------------------------------------------------------------------
def _small_platform(seed=0, n=500):
    t, centers = _table(MMOTable, seed, n)
    p = MQRLD(t, seed=seed, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p, centers


def test_cost_model_persists_in_snapshot():
    """test_cost.py's: cost_model.json beside platform.json, with its
    version; the model's kinds, the QBS cost rings and the refit cursor
    survive."""
    p, _ = _small_platform(seed=4)
    for j in range(10):
        p.qbs.record_cost("knn:host", [1.0 + j] * costm.KNN_FEATURE_DIM,
                          0.01 * (j + 1))
    p.cost_model = costm.CostModel()
    p.cost_model.fit_from_qbs(p.qbs)
    p.qbs.record_cost("knn:host", [1.0] * costm.KNN_FEATURE_DIM, 0.01)
    with tempfile.TemporaryDirectory() as dd:
        save_platform(p, dd)
        snap = _resolve_snapshot(dd)
        with open(os.path.join(snap, "cost_model.json")) as f:
            assert json.load(f)["version"] == costm.COST_MODEL_VERSION
        p2 = load_platform(dd, device="cpu")
        assert p2.cost_model is not None
        assert p2.cost_model.kinds == p.cost_model.kinds
        assert p2.qbs.cost.keys() == p.qbs.cost.keys()
        assert p2.qbs.cost_total == p.qbs.cost_total == 11


def test_persist_roundtrip_int8_default(tmp_path):
    """test_precision.py's: an int8 default persists its planes, the
    reloaded default session scans int8 with the fp32 rows, and its engine
    holds the snapshot's planes."""
    p, _ = _small_platform(seed=23)
    p.default_precision = "int8"
    cases = [Q.VK.of("img", p.table.vector["img"][3], 9)]
    ref, _ = p.session(precision="fp32").execute(cases)
    p.engine()
    save_platform(p, str(tmp_path))
    assert os.path.exists(
        os.path.join(_resolve_snapshot(str(tmp_path)), "quant.npz"))
    p2 = load_platform(str(tmp_path), device="cpu")
    assert p2.default_precision == "int8"
    assert p2._quant_cache["precision"] == "int8"
    got, stats = p2.session().execute(cases)
    assert np.array_equal(ref[0], got[0])
    assert stats.mp_scanned > 0
    for k, v in p2.engine().snapshot_planes().items():
        np.testing.assert_array_equal(v, p2._quant_cache[k])


def test_no_planes_without_an_int8_default(tmp_path):
    """Only an int8 default with a built engine of that precision writes
    quant.npz (bf16 planes are a cast)."""
    p, _ = _small_platform(seed=24)
    p.default_precision = "bf16"
    p.engine()
    save_platform(p, str(tmp_path))
    assert not os.path.exists(
        os.path.join(_resolve_snapshot(str(tmp_path)), "quant.npz"))
    assert load_platform(str(tmp_path), device="cpu")._quant_cache is None


def test_stale_planes_are_requantized(tmp_path, monkeypatch):
    """Planes whose shape does not match the tiles are not taken: the
    engine quantizes, and the rows stay the fp32 rows."""
    p, _ = _small_platform(seed=25)
    p.default_precision = "int8"
    p.engine()
    save_platform(p, str(tmp_path))
    p2 = load_platform(str(tmp_path), device="cpu")
    key = "dev__img__data"
    p2._quant_cache[key] = p2._quant_cache[key][:-1]
    calls = _count_plan_tiles(monkeypatch, tquant)
    eng = p2.engine()
    assert len(calls) == 1
    assert not np.shares_memory(eng._planes_np[("dev", "img")].data,
                                p2._quant_cache[key])
    q = [Q.VK.of("img", p.table.vector["img"][5], 6)]
    want, _ = p2.session(precision="fp32").execute(q)
    got, _ = p2.session().execute(q)
    np.testing.assert_array_equal(got[0], want[0])


def test_qbs_convergence_persistence_roundtrip(tmp_path):
    """test_planner.py's, through both packages' files."""
    t = QBSTable()
    t.record_convergence("VK:v:k5:plain:dl", 12)
    t.record_convergence("VK:v:k5:plain:dl", 20)
    path = str(tmp_path / "qbs.json")
    t.save(path)
    for cls in (QBSTable, JQBSTable):
        back = cls.load(path)
        assert back.convergence == {"VK:v:k5:plain:dl": [12, 20]}
        assert back.convergence_width("VK:v:k5:plain:dl") >= 12
        assert back.convergence_width("unseen") is None


def test_qbs_legacy_and_oversized_files(tmp_path):
    """A bare row list (the legacy format) loads with empty rings and a
    zero cursor; an oversized row log re-enters under ``_ROWS_KEEP``; a
    file without ``cost_total`` seeds it from the rings."""
    row = dict(statement="q", object_set="t", attributes=["v"],
               types=["VK"], recall_at_k=1.0, cbr=0.5, query_time_s=0.01,
               accuracy=1.0, task="", ts=0.0)
    path = str(tmp_path / "legacy.json")
    with open(path, "w") as f:
        json.dump([dict(row, statement=f"q{i}")
                   for i in range(_ROWS_KEEP + 10)], f)
    t = QBSTable.load(path)
    assert len(t) == _ROWS_KEEP and t.rows[0].statement == "q10"
    assert t.convergence == {} and t.latency == {} and t.cost_total == 0
    with open(path, "w") as f:
        json.dump({"rows": [row], "cost": {"knn:host": [[[1.0], 0.1]] * 3}},
                  f)
    t = QBSTable.load(path)
    assert t.cost_total == 3 and len(t) == 1


def test_lake_persistence_roundtrip():
    """test_query_platform.py's, on the port's ``DataLake``; the
    reference reads the same directory."""
    p, _ = _small_platform(seed=5)
    p.table.embed_model["img"] = "clip"
    with tempfile.TemporaryDirectory() as d:
        lake = DataLake(d)
        lake.write(p.table)
        assert lake.list_tables() == ["persist"]
        for back in (lake.read("persist"),
                     JTable.load(os.path.join(d, "persist"))):
            assert back.n_rows == p.table.n_rows
            np.testing.assert_array_equal(back.numeric["price"],
                                          p.table.numeric["price"])
            np.testing.assert_array_equal(back.bucket_starts,
                                          p.table.bucket_starts)
            assert back.embed_model["img"] == "clip"


def test_delta_survives_save_load():
    """test_ingest.py's: a live delta round-trips, answers on every path,
    and the reloaded platform keeps ingesting and folding."""
    p, centers = _small_platform(seed=9)
    rng = np.random.default_rng(12)
    r = _rows(rng, centers, 8)
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)
    q = Q.And.of(Q.NR("price", 5, 95),
                 Q.VK.of("img", p.table.vector["img"][4], 6))
    want = set(p.oracle(q).tolist())
    with tempfile.TemporaryDirectory() as dd:
        save_platform(p, dd)
        p2 = load_platform(dd, device="cpu")
        assert p2.n_delta == 8
        got, _ = p2.execute(q, record=False)
        assert set(got.tolist()) == want
        for dl in (True, False):
            (gb,), _ = p2.execute_batch([q], device_loop=dl)
            assert set(gb.tolist()) == want, dl
        more = _rows(rng, centers, 3)
        p2.append(numeric=more["numeric"], vector=more["vector"],
                  raw_uri=more["raw_uri"], fold=False)
        assert p2.n_delta == 11
        assert p2.fold() == 11
        (gf,), _ = p2.execute_batch([q])
        assert len(gf) == len(want)


def test_fold_after_load_with_column_subset():
    """test_ingest.py's: a column subset's order round-trips through the
    index manifest, so a fold after the load feeds the frozen transform
    the right features."""
    rng = np.random.default_rng(21)
    n = 400
    img = rng.normal(size=(n, 8)).astype(np.float32) * 4
    audio = rng.normal(size=(n, 5)).astype(np.float32)
    t = (MMOTable("subset").add_vector("img", img)
         .add_vector("audio", audio)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = MQRLD(t, seed=0, device="cpu")
    p.prepare(columns=["img"], min_leaf=8, max_leaf=64)
    with tempfile.TemporaryDirectory() as dd:
        save_platform(p, dd)
        p2 = load_platform(dd, device="cpu")
        assert list(p2.layout) == ["img"]
        p2.append(numeric={"price": [10.0, 20.0]},
                  vector={"img": rng.normal(size=(2, 8)).astype(np.float32),
                          "audio": rng.normal(size=(2, 5)).astype(np.float32)},
                  fold=False)
        assert p2.fold() == 2
        q = Q.VK.of("img", img[3], 5)
        got, _ = p2.execute(q, record=False)
        assert set(got.tolist()) == set(p2.oracle(q).tolist())


# ---------------------------------------------------------------------------
# Generations: CURRENT, retention, crash atomicity, rollback
# ---------------------------------------------------------------------------
def _gen_rows(p, qs):
    rows, _ = p.session().plan(qs).execute()
    return rows


def test_generation_numbers_follow_prepare_and_fold():
    p, centers = _small_platform(seed=30)
    assert p.generation == 1
    r = _rows(np.random.default_rng(1), centers, 4)
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)
    assert p.generation == 1          # an append is not a generation
    p.fold()
    assert p.generation == 2
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    assert p.generation == 3


def test_current_flips_and_two_generations_are_kept(tmp_path):
    p, centers = _small_platform(seed=31)
    rng = np.random.default_rng(2)
    d = str(tmp_path)
    seen = []
    for _ in range(3):
        save_platform(p, d)
        seen.append(current_generation(d))
        assert p.snapshot_dir == d
        r = _rows(rng, centers, 5)
        p.append(numeric=r["numeric"], vector=r["vector"],
                 raw_uri=r["raw_uri"], fold=False)
        p.fold()
    assert seen == [1, 2, 3]
    assert list_generations(d) == [2, 3]
    assert sorted(os.listdir(d)) == ["CURRENT", "gen-0002", "gen-0003"]
    # a re-save of an unchanged generation takes the next free number
    save_platform(p, d)
    save_platform(p, d)
    assert current_generation(d) == p.generation + 1
    assert list_generations(d) == [p.generation, p.generation + 1]
    with open(os.path.join(d, "CURRENT")) as f:
        assert f.read() == f"gen-{p.generation + 1:04d}"


def test_save_that_raises_leaves_the_old_generation_serving(tmp_path,
                                                          monkeypatch):
    p, centers = _small_platform(seed=32)
    d = str(tmp_path)
    q = [Q.VK.of("img", p.table.vector["img"][7], 5)]
    save_platform(p, d)
    before = _gen_rows(load_platform(d, device="cpu"), q)
    r = _rows(np.random.default_rng(3), centers, 6)
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)
    p.fold()

    def boom(path):
        raise OSError("disk full")
    monkeypatch.setattr(p.qbs, "save", boom)
    with pytest.raises(OSError, match="disk full"):
        save_platform(p, d)
    assert current_generation(d) == 1
    assert sorted(os.listdir(d)) == ["CURRENT", "gen-0001"]
    p2 = load_platform(d, device="cpu")
    assert p2.n_base == p.n_base - 6
    np.testing.assert_array_equal(_gen_rows(p2, q)[0], before[0])


def test_rollback_platform_fresh_and_into(tmp_path):
    """Two saves, then ``rollback_platform``: a fresh platform with the
    first generation's rows and CURRENT flipped back; ``into=`` grafts it
    onto a live platform (build id and generation advance, plans and
    engines invalidate)."""
    p, centers = _small_platform(seed=33)
    d = str(tmp_path)
    qs = _queries(Q, p.table, 0)[:4]
    first = _gen_rows(p, qs)
    save_platform(p, d)
    r = _rows(np.random.default_rng(4), centers, 30)
    r["vector"]["img"][:] = p.table.vector["img"][3] + 1e-3
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)
    p.fold()
    second = _gen_rows(p, qs)
    assert not all(np.array_equal(a, b) for a, b in zip(first, second))
    save_platform(p, d)
    assert current_generation(d) == 2
    fresh = rollback_platform(d, device="cpu")
    assert current_generation(d) == 1
    assert fresh.generation == 1 and fresh.snapshot_dir == d
    for a, b in zip(_gen_rows(fresh, qs), first):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="no generation older"):
        rollback_platform(d, device="cpu")
    tpersist._set_current(d, 2)
    build, gen = p.build_id, p.generation
    sess = p.session()
    assert rollback_platform(d, into=p) is p
    assert current_generation(d) == 1
    assert p.build_id == build + 1 and p.generation == gen + 1
    assert p.n_base == fresh.n_base and p._engines == {}
    assert sess.plan(qs).cache_hit is False
    for a, b in zip(_gen_rows(p, qs), first):
        np.testing.assert_array_equal(a, b)


def test_platform_rollback_uses_disk(tmp_path):
    """``MQRLD.rollback()`` on a platform that never swapped: the disk
    branch from ``snapshot_dir``, and the reference's error without
    one."""
    p, centers = _small_platform(seed=34)
    with pytest.raises(RuntimeError, match="no snapshot_dir"):
        p.rollback()
    d = str(tmp_path)
    save_platform(p, d)
    n0 = p.n_base
    r = _rows(np.random.default_rng(5), centers, 9)
    p.append(numeric=r["numeric"], vector=r["vector"], raw_uri=r["raw_uri"],
             fold=False)
    p.fold()
    save_platform(p, d)
    gen = p.generation
    assert p.rollback() == gen + 1
    assert p.n_base == n0 and current_generation(d) == 1
    q = Q.VK.of("img", p.table.vector["img"][2], 6)
    (rows,), _ = p.execute_batch([q])
    np.testing.assert_array_equal(rows, p.oracle(q))


def test_rollback_without_versions_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CURRENT"):
        rollback_platform(str(tmp_path), device="cpu")


def test_legacy_flat_snapshot_loads(tmp_path):
    """A directory without CURRENT loads as a flat snapshot, and a pinned
    ``generation`` reads that generation."""
    p, _ = _small_platform(seed=35)
    d = str(tmp_path)
    tpersist._write_snapshot(p, d)
    p2 = load_platform(d, device="cpu")
    assert p2.snapshot_dir is None and p2.n_base == p.n_base
    d2 = str(tmp_path / "versioned")
    save_platform(p, d2)
    save_platform(p, d2)
    p3 = load_platform(d2, generation=1, device="cpu")
    assert p3.snapshot_dir == d2 and p3.generation == 1


def test_default_shards_stored_and_clamped(tmp_path):
    """``default_shards`` rides in platform.json; on load it is clamped to
    the devices the loader has (one on the CPU) and ``shards`` overrides
    it."""
    p, _ = _small_platform(seed=36)
    p.default_shards = 4
    save_platform(p, str(tmp_path))
    with open(os.path.join(_resolve_snapshot(str(tmp_path)),
                           "platform.json")) as f:
        assert json.load(f)["default_shards"] == 4
    assert load_platform(str(tmp_path), device="cpu").default_shards == 1
    assert load_platform(str(tmp_path), shards=0,
                         device="cpu").default_shards == 0
