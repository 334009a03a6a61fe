"""Sharded hybrid-query execution in the port: shard-count invariance.

Counterparts of the reference's ``tests/test_sharding.py``, of the
sharded cases of ``tests/test_precision.py`` and of
``tests/test_cost.py::test_cost_driven_sharded_plans_oracle_exact``, at
S in {1, 2, 8}, all on the CPU: a mesh of any S runs on one device.

* Against the reference's own functions: ``strided_tile_layout`` gives
  the reference's permutation bit for bit; ``knn_kind``,
  ``shards_of_kind``, ``loop_widths``, ``knn_features`` and
  ``knn_plan_features`` equal the reference's at S in {0, 1, 2, 8};
  ``knn_archetype`` and ``group_job_specs`` give its tags.
* Against the port's single-device loop and the oracle: the reference's
  sharded path does not run on this tree, so the port is held to its own
  single-device loop (itself held to the reference elsewhere) and to the
  brute-force oracle. Every comparison is exact, ids and order: the
  engine's certified re-rank orders candidates as the oracle does, so an
  exact tie at the k-th distance resolves alike at every shard count.
"""
import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.sharding.partitioning import \
    strided_tile_layout as j_strided_tile_layout
from repro_torch.core import cost as tcost
from repro_torch.core import engine as tengine
from repro_torch.core import query as Q
from repro_torch.core.engine import (EnginePlan, EngineStats, HybridEngine,
                                     batched_knn_device, batched_knn_sharded)
from repro_torch.core.lake import MMOTable
from repro_torch.core.persist import load_platform, save_platform
from repro_torch.core.planner import Session
from repro_torch.serve.engine import RetrievalRequest, RetrievalServer
from repro_torch.core.platform import MQRLD
from repro_torch.sharding import (LocalCollectives, shard_put,
                                  strided_tile_layout, tile_mesh)

torch.set_num_threads(1)

SHARD_COUNTS = (1, 2, 8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def platform():
    rng = np.random.default_rng(0)
    n, d = 1800, 10
    centers = rng.normal(size=(6, d)).astype(np.float32) * 7
    lab = rng.integers(0, 6, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    aud = rng.normal(size=(n, 6)).astype(np.float32)
    t = (MMOTable("shard_shop")
         .add_vector("img", vec)
         .add_vector("audio", aud)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = MQRLD(t, seed=0, device="cpu")
    p.prepare(min_leaf=16, max_leaf=128, dpc_max_clusters=6)
    return p


def _cases(p):
    v1 = p.table.vector["img"][10]
    v2 = p.table.vector["audio"][10]
    return [
        Q.VK.of("img", v1, 12),
        Q.And.of(Q.NR("price", 20, 80), Q.VK.of("img", v1, 10)),
        Q.VR.of("img", v1, 3.5),
        Q.And.of(Q.VR.of("img", v1, 5.0), Q.VK.of("img", v1, 10)),
        Q.And.of(Q.VR.of("img", v1, 6.0), Q.VR.of("audio", v2, 4.0)),
        Q.Or.of(Q.NR("price", 0, 5), Q.VR.of("img", v1, 2.0)),
        Q.And.of(Q.NR("price", 40, 41), Q.VK.of("img", v1, 50)),
        Q.NR("price", 200, 300),
    ]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (what, i)


# ---------------------------------------------------------------------------
# placement layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,s", [(7, 2), (16, 8), (1, 4), (395, 8),
                                 (100, 1)])
def test_strided_layout_equals_the_references(t, s):
    perm, tl, tp = strided_tile_layout(t, s)
    jperm, jtl, jtp = j_strided_tile_layout(t, s)
    assert (tl, tp) == (jtl, jtp)
    assert perm.dtype == jperm.dtype and np.array_equal(perm, jperm)
    assert tp == tl * s and sorted(perm.tolist()) == list(range(tp))
    for pos, orig in enumerate(perm):     # shard s owns t = s (mod S)
        if orig < t:
            assert orig % s == pos // tl


def test_tile_mesh_places_shards_on_the_devices_there_are():
    """Any S runs (the reference raises above its device count), every
    shard on the one device; S < 1 raises; ``shard_put`` gives each shard
    a view of one upload."""
    with pytest.raises(ValueError):
        tile_mesh(0, "cpu")
    m = tile_mesh(8, "cpu")
    assert m.shards == 8 and m.device == CPU
    assert isinstance(m.collectives, LocalCollectives)
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    v = shard_put(x, tile_mesh(4, "cpu"))
    assert v.shape == (4, 3, 2) and np.array_equal(v[2].numpy(), x[6:9])
    assert v.flatten(0, 1).data_ptr() == v[0].data_ptr()
    with pytest.raises(ValueError):
        shard_put(x[:10], tile_mesh(4, "cpu"))
    c = LocalCollectives()
    a = torch.arange(12.).view(3, 4)
    assert torch.equal(c.all_gather(a), a)
    assert torch.equal(c.pmin(a), a[0]) and torch.equal(c.psum(a),
                                                        a.sum(0))


# ---------------------------------------------------------------------------
# cost model and grouping against the reference's functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", (0,) + SHARD_COUNTS)
def test_cost_functions_equal_the_references(shards):
    for dl in (False, True):
        kind = tcost.knn_kind(dl, shards)
        assert kind == jcost.knn_kind(dl, shards)
        assert tcost.shards_of_kind(kind) == jcost.shards_of_kind(kind)
    for kind in ("knn:sharded:s", "knn:sharded:sx", "vr:tile"):
        assert tcost.shards_of_kind(kind) == jcost.shards_of_kind(kind)
    for dl in (False, True):
        for beam in (1, 5, 16):
            for tiles in (1, 3, 40, 395):
                for seed in (None, 1, 7, 64):
                    w = tcost.loop_widths(dl, shards, beam, tiles, seed)
                    assert w == jcost.loop_widths(dl, shards, beam, tiles,
                                                  seed)
                    kw = dict(device_loop=dl, shards=shards, g=37, k=20,
                              beam=beam, tiles=tiles, cap=64, dim=512,
                              precision="int8", seed=seed)
                    assert tcost.knn_plan_features(**kw) == \
                        jcost.knn_plan_features(**kw)
    for prec in ("fp32", "bf16", "int8"):
        args = (256, 3, 2, 64, 512, 28, 395, shards, prec)
        assert tcost.knn_features(*args) == jcost.knn_features(*args)


@pytest.mark.parametrize("shards", (0,) + SHARD_COUNTS)
def test_archetypes_and_groups_equal_the_references(shards):
    specs = (("img", 10, True), ("img", 12, False), ("audio", 5, True),
             ("img", 50, True), ("audio", 7, False))
    for dl in (False, True):
        for masked in (False, True):
            assert tengine.knn_archetype("img", 12, masked, dl, shards) == \
                jengine.knn_archetype("img", 12, masked, dl, shards)
        got = tengine.group_job_specs(specs, dl, shards)
        want = jengine.group_job_specs(specs, dl, shards)
        assert [(g.attr, g.jobs, g.kmax, g.n_masked, g.archetype)
                for g in got] == \
            [(g.attr, g.jobs, g.kmax, g.n_masked, g.archetype)
             for g in want]


# ---------------------------------------------------------------------------
# engine parity at every shard count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_execute_batch_sharded_parity(platform, shards):
    p = platform
    cases = _cases(p)
    single, _ = p.engine(shards=0).execute_batch(cases)
    eng = HybridEngine(p.tree, p.table, p.meta, device="cpu", shards=shards)
    got, stats = eng.execute_batch(cases)
    assert stats.shards == shards
    _same(got, single, shards)
    _same(got, [p.oracle(q) for q in cases], shards)
    _, hstats = eng.execute_batch(cases, device_loop=False)
    assert hstats.shards == 0


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_batched_knn_sharded_matches_device_loop(platform, shards):
    """The sharded beam loop alone: its rows and distances equal the
    single-device loop's, with and without masks, at k = 1, a typical k
    and k above the masked rows, and each is the brute-force top-k."""
    p = platform
    eng = HybridEngine(p.tree, p.table, p.meta, device="cpu", shards=shards)
    col = np.asarray(p.table.vector["img"])
    rng = np.random.default_rng(7)
    qs = torch.as_tensor(
        (col[rng.integers(0, len(col), 6)]
         + rng.normal(size=(6, col.shape[1])) * 0.3).astype(np.float32))
    mask = np.asarray(p.table.numeric["price"]) < 35.0
    for use_mask in (False, True):
        m = torch.as_tensor(np.broadcast_to(mask, (6, len(mask))).copy()) \
            if use_mask else None
        for k in (1, 8, 40):
            stats = EngineStats()
            ds, rs = batched_knn_sharded(
                eng.sharded_dev, eng.geom_dev["img"],
                eng.vec_tiles_dev["img"], qs, k, masks=m, beam=8,
                stats=stats)
            dd, rd = batched_knn_device(eng.geom_dev["img"],
                                        eng.vec_tiles_dev["img"], qs, k,
                                        masks=m, beam=8)
            assert np.array_equal(rs, rd), (shards, use_mask, k)
            assert np.array_equal(ds, dd), (shards, use_mask, k)
            assert stats.rows_scanned > 0
            d2 = ((col[None] - qs.numpy()[:, None]) ** 2).sum(-1)
            if use_mask:
                d2 = np.where(mask[None], d2, np.inf)
            for i in range(len(qs)):
                sel = np.argsort(d2[i], kind="stable")[:k]
                want = set(sel[np.isfinite(d2[i][sel])].tolist())
                assert set(rs[i][rs[i] >= 0].tolist()) == want


def test_sharded_empty_mask(platform):
    """A filter admitting no row retires in the first round at every
    shard count instead of looping to the budget."""
    p = platform
    for shards in SHARD_COUNTS:
        eng = HybridEngine(p.tree, p.table, p.meta, device="cpu",
                           shards=shards)
        qs = torch.as_tensor(np.asarray(p.table.vector["img"][:3]))
        masks = torch.zeros((3, p.table.n_rows), dtype=torch.bool)
        stats = EngineStats()
        _, rows = batched_knn_sharded(
            eng.sharded_dev, eng.geom_dev["img"], eng.vec_tiles_dev["img"],
            qs, 5, masks=masks, beam=8, stats=stats)
        assert (rows == -1).all(), shards
        assert stats.knn_rounds == 1, shards


def test_sharded_layout_holds_every_tile_once(platform):
    """Each base tile of both layouts sits on shard t mod S at its strided
    position, live, and once; pads are not live; the device arrays are
    the host index's."""
    p = platform
    eng = HybridEngine(p.tree, p.table, p.meta, device="cpu", shards=8)
    for st, t in ((eng.sharded_dev, eng.geom_dev["img"].n_leaves),
                  (eng.sharded_vr, eng.n_tiles)):
        assert st.t_base == t and st.td == 0 and st.shards == 8
        for pos, orig in enumerate(st.perm):
            s, j = divmod(pos, st.t_local)
            if orig < t:
                assert orig % 8 == s
                assert st.local_np[s, j] == orig and st.live_np[s, j]
            else:
                assert not st.live_np[s, j]
        assert sorted(st.local_np[st.live_np].tolist()) == list(range(t))
        assert np.array_equal(st.local.numpy(), st.local_np)
        assert np.array_equal(st.live.numpy(), st.live_np)


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_vr_tile_route_sharded(platform, shards, monkeypatch):
    """The sharded V.R route (the bound and the union pass per shard):
    forced past the dense cutoff, its masks equal the single-device tile
    route's and the dense pass's, and its survival matrix the
    single-device bound's."""
    p = platform
    monkeypatch.setattr(tengine, "_VR_DENSE_CUTOFF", 2.0)
    v = p.table.vector["img"]
    grp = [Q.VR.of("img", v[i], r) for i, r in
           ((10, 3.5), (400, 2.0), (901, 5.0), (1500, 0.5))]
    single = p.engine(shards=0)
    eng = HybridEngine(p.tree, p.table, p.meta, device="cpu", shards=shards)
    for e in (single, eng):
        e.cost_model = None
    st1, st2 = EngineStats(), EngineStats()
    m1, t1 = single._vr_masks("img", grp, st1, True)
    m2, t2 = eng._vr_masks("img", grp, st2, True)
    m3, _ = eng._vr_masks("img", grp, EngineStats(), False)
    assert st2.vr_tiles_scanned > 0 and st2.vr_dense_fallbacks == 0
    assert t1 == t2 and np.array_equal(m1, m2) and np.array_equal(m2, m3)
    qs = torch.as_tensor(np.stack([b.vec() for b in grp]))
    r = torch.as_tensor([b.radius for b in grp], dtype=torch.float32)
    leaf_ok, _ = eng._vr_plan_sharded("img", qs, r)
    want = tengine._vr_leaf_plan(qs, r, eng.geom["img"].centroid,
                                 eng.geom["img"].radius).numpy()
    assert np.array_equal(leaf_ok, want)


def test_with_shards_shares_the_twins_layouts(platform):
    """A sharded engine derived from the single-device one gives a fresh
    sharded engine's rows, shares the twin's tiles, and leaves the twin
    as it was."""
    p = platform
    cases = _cases(p)
    twin = HybridEngine(p.tree, p.table, p.meta, device="cpu")
    before, _ = twin.execute_batch(cases)
    eng = twin.with_shards(2)
    fresh = HybridEngine(p.tree, p.table, p.meta, device="cpu", shards=2)
    a, sa = eng.execute_batch(cases)
    b, sb = fresh.execute_batch(cases)
    _same(a, b, "with_shards")
    assert sa.shards == sb.shards == 2
    assert eng.vec_tiles_dev["img"] is twin.vec_tiles_dev["img"]
    assert twin.shards is None and twin.sharded_dev is None
    after, st = twin.execute_batch(cases)
    _same(after, before, "twin")
    assert st.shards == 0


# ---------------------------------------------------------------------------
# planner / session / platform
# ---------------------------------------------------------------------------
def test_host_loop_oracle_on_sharded_session(platform):
    """device_loop=False stays usable on a sharded session: host-loop
    plans carry shards=0 and run the single-device paths."""
    p = platform
    cases = _cases(p)[:4]
    rows_h, stats = p.session(shards=2).plan(
        cases, device_loop=False).execute()
    assert stats.shards == 0
    _same(rows_h, [p.oracle(q) for q in cases], "host")
    p.default_shards = 2
    try:
        rows_h2, _ = p.session(device_loop=False).plan(cases).execute()
        _same(rows_h2, rows_h, "default")
    finally:
        p.default_shards = None
        p._sessions.clear()


def test_session_shards_zero_forces_single_device(platform):
    """session(shards=0) forces one device under a platform default: it
    neither aliases the defaulted session nor resolves back to it."""
    p = platform
    p.default_shards = 2
    try:
        s_off = p.session(shards=0)
        s_def = p.session()
        assert s_off is not s_def and s_off.shards is None
        assert s_def.shards == 2
        q = _cases(p)[0]
        (rows,), stats = s_off.plan([q]).execute()
        assert stats.shards == 0
        (rows2,), stats2 = s_def.plan([q]).execute()
        assert stats2.shards == 2
        assert np.array_equal(rows, p.oracle(q))
        assert np.array_equal(rows2, rows)
        assert p.engine() is p.engine(shards=2)
        assert p.engine(shards=0).shards is None
    finally:
        p.default_shards = None
        p._sessions.clear()


def test_engine_plan_shard_mismatch_raises(platform):
    p = platform
    plan = p.session(shards=2).plan([_cases(p)[0]])
    lp = plan.logical
    assert lp.shards == 2
    bad = EnginePlan(device_loop=True, job_specs=lp.job_specs,
                     groups=lp.groups, shards=2)
    with pytest.raises(ValueError, match="shards"):
        p.engine(shards=0).execute_batch([plan.norm[0]], plan=bad)
    with pytest.raises(ValueError, match="shards"):
        p.engine(shards=8).execute_batch([plan.norm[0]], plan=bad)
    host = EnginePlan(device_loop=False, job_specs=lp.job_specs,
                      groups=tengine.group_job_specs(lp.job_specs, False),
                      shards=0)
    rows, _ = p.engine(shards=8).execute_batch([plan.norm[0]], plan=host)
    assert np.array_equal(rows[0], p.oracle(_cases(p)[0]))


def test_session_plans_cache_per_topology(platform):
    p = platform
    cases = _cases(p)[:3]
    s1 = p.session(shards=1)
    s1.plan(cases)
    hits0 = s1.cache_hits
    s1.plan(cases)
    assert s1.cache_hits == hits0 + 1
    assert p.session(shards=1) is s1
    assert p.session() is not s1 and p.session(shards=8) is not s1
    ex = s1.plan(cases).explain()
    assert ex["shards"] == 1
    assert ":s1" in ex["knn_groups"][0]["archetype"]
    assert p.session().plan(cases).explain()["shards"] == 0
    assert p.session(shards=8).plan(cases).explain()["shards"] == 8
    assert p.session(shards=8).plan(
        cases, device_loop=False).explain()["shards"] == 0


def test_explain_and_widths_key_per_shard_count(platform):
    """Widths recorded by a sharded batch land under the ``:sS``
    archetype the next plan's seed is read from."""
    p = platform
    sess = p.session(shards=8)
    q = _cases(p)[:2]
    sess.plan(q).execute()
    keys = [k for k in p.qbs.convergence if k.endswith(":dl:s8")]
    assert keys
    ex = sess.plan(q).explain()
    assert all(g["archetype"].endswith(":dl:s8") for g in ex["knn_groups"])


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_retrieval_server_sharded(platform, shards):
    p = platform

    class Stub:
        def embed(self, toks):
            rows = np.asarray(toks)[:, 0] % p.table.n_rows
            return np.asarray(p.table.vector["img"][rows]) + 0.01

    srv = RetrievalServer(p, Stub(), batch_size=4, shards=shards)
    assert srv.session.shards == shards
    reqs = [RetrievalRequest(tokens=np.asarray([i, 1], np.int32),
                             attr="img", k=5,
                             predicate=Q.NR("price", 10, 90))
            for i in (3, 50, 999)]
    reqs.append(RetrievalRequest(tokens=np.asarray([7, 2], np.int32),
                                 attr="img", k=9))
    for res in srv.serve(reqs):
        assert 0 < len(res.rows) <= 9
        assert set(res.rows.tolist()) == set(p.oracle(res.query).tolist())


def test_persist_shard_topology_roundtrip(tmp_path, platform):
    """``default_shards`` rides in platform.json; the loaded platform
    serves through the sharded path, and ``shards=None`` keeps the saved
    count."""
    p = platform
    p.default_shards = 1
    try:
        save_platform(p, str(tmp_path))
        p2 = load_platform(str(tmp_path), device="cpu")
        assert p2.default_shards == 1
        q = Q.VK.of("img", p.table.vector["img"][3], 7)
        (rows,), stats = p2.session().plan([q]).execute()
        assert stats.shards == 1
        assert np.array_equal(rows, p.oracle(q))
        p3 = load_platform(str(tmp_path), shards=None, device="cpu")
        assert p3.default_shards == 1
        p4 = load_platform(str(tmp_path), shards=0, device="cpu")
        (rows4,), stats4 = p4.session().plan([q]).execute()
        assert stats4.shards == 0 and np.array_equal(rows4, rows)
    finally:
        p.default_shards = None
        p._sessions.clear()
        p._engines.clear()


# ---------------------------------------------------------------------------
# mixed precision, sharded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ("int8", "bf16"))
def test_rows_identical_sharded(platform, precision):
    p = platform
    cases = _cases(p)
    for s in SHARD_COUNTS:
        ref, _ = p.session(shards=s, precision="fp32").execute(cases)
        got, stats = p.session(shards=s, precision=precision
                               ).execute(cases)
        _same(got, ref, (s, precision))
        assert stats.mp_scanned > 0 and stats.shards == s


# ---------------------------------------------------------------------------
# seeded fuzz: shard-count invariance over base + delta, appends and folds
# ---------------------------------------------------------------------------
_FUZZ_KS = (1, 5, 17)


def _fuzz_platform(seed=11):
    rng = np.random.default_rng(seed)
    n = 600
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 5
    lab = rng.integers(0, 5, n)
    img = (centers[lab] + rng.normal(size=(n, 8))).astype(np.float32)
    t = (MMOTable("fuzz_sh")
         .add_vector("img", img)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = MQRLD(t, seed=2, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p, centers


def _rand_query(rng, tab):
    col = tab.vector["img"]
    base = col[rng.integers(0, len(col))]
    v = (base + rng.normal(size=col.shape[1]).astype(np.float32)
         * np.float32(rng.uniform(0, 0.5))).astype(np.float32)
    kind = rng.integers(0, 4)
    if kind == 0:
        return Q.VK.of("img", v, int(rng.choice(_FUZZ_KS)))
    if kind == 1:
        lo = float(rng.uniform(-10, 90))
        return Q.And.of(Q.NR("price", lo, lo + float(rng.uniform(5, 60))),
                        Q.VK.of("img", v, int(rng.choice(_FUZZ_KS))))
    anchor = col[rng.integers(0, len(col))]
    r = float(np.sqrt(((anchor - v) ** 2).sum())
              * rng.uniform(0.4, 1.4)) + 1e-3
    if kind == 2:
        return Q.VR.of("img", v, r)
    return Q.And.of(Q.VR.of("img", v, max(r, 2.0)),
                    Q.VK.of("img", v, int(rng.choice(_FUZZ_KS))))


def test_fuzz_shard_count_invariance():
    """Seeded append / query / fold interleavings: every batch runs on the
    host loop, the single-device loop and the sharded loop at S = 1, 2
    and 8 in fp32, and at S = 8 in int8 and bf16; all give the oracle's
    rows over base + delta at that instant, and the sharded rows equal
    the single-device loop's."""
    p, centers = _fuzz_platform()
    rng = np.random.default_rng(1234)
    host = p.session(device_loop=False, precision="fp32")
    single = p.session(shards=0, precision="fp32")
    sharded = [p.session(shards=s, precision="fp32") for s in SHARD_COUNTS]
    sharded += [p.session(shards=8, precision=pr) for pr in ("int8", "bf16")]

    def check_batch(step):
        batch = [_rand_query(rng, p.table) for _ in range(4)]
        truth = [p.oracle(q) for q in batch]
        got_h, _ = host.plan(batch).execute()
        _same(got_h, truth, ("host", step))
        got_1, _ = single.plan(batch).execute()
        _same(got_1, truth, ("single", step))
        for sess in sharded:
            got, st = sess.plan(batch).execute()
            assert st.shards == sess.shards
            _same(got, got_1, (sess.shards, sess.precision, step))

    check_batch("base")
    for step in range(6):
        m = int(rng.integers(5, 40))
        cat = rng.integers(0, 5, m)
        dvec = (centers[cat] + rng.normal(size=(m, 8))).astype(np.float32)
        p.append(vector={"img": dvec},
                 numeric={"price": rng.uniform(0, 100, m)
                          .astype(np.float32)}, fold=False)
        assert p.engine(shards=8).sharded_dev.td > 0
        check_batch(step)
        if step in (2, 4):
            p.fold()
            check_batch(f"fold {step}")


def test_delta_lives_on_shard_zero_only():
    """After an append every shard sees the delta tiles after its own,
    and only shard 0's copies bound below +inf."""
    p, centers = _fuzz_platform(seed=5)
    rng = np.random.default_rng(2)
    p.append(vector={"img": (centers[rng.integers(0, 5, 30)]
                             + rng.normal(size=(30, 8))).astype(np.float32)},
             numeric={"price": rng.uniform(0, 100, 30).astype(np.float32)},
             fold=False)
    eng = p.engine(shards=4)
    st = eng.sharded_dev
    assert st.td > 0 and st.t_total == st.t_local + st.td
    tl = st.t_local
    assert st.live_np[0, tl:].all() and not st.live_np[1:, tl:].any()
    assert (st.local_np[:, tl:] == st.t_base + np.arange(st.td)).all()
    rows = eng.geom_dev["img"].bucket_rows[st.local[0, tl:]].numpy()
    live = rows[rows >= 0]
    assert live.min() >= p.n_base and len(live) == 30
    order, lb = tengine._sharded_prologue(
        eng.vec["img"][:3], st, eng.geom_dev["img"], None)
    lb = torch.empty_like(lb).scatter_(2, order, lb)     # (S, G, L)
    assert bool(torch.isinf(lb.transpose(0, 1)[:, ~st.live]).all())


# ---------------------------------------------------------------------------
# cost-driven sharded plans
# ---------------------------------------------------------------------------
def _bias_model(kinds_err):
    """A CostModel whose kinds are all fitted and reliable, predicting a
    constant per kind (the bias weight)."""
    kinds = {}
    for kind, secs in kinds_err.items():
        dim = tcost.VR_FEATURE_DIM if kind.startswith("vr:") \
            else tcost.KNN_FEATURE_DIM
        w = [0.0] * dim
        w[0] = secs
        kinds[kind] = {"w": w, "n": 64, "err": 0.01}
    return tcost.CostModel(kinds=kinds)


def test_cost_driven_sharded_plans_oracle_exact(platform):
    """A calibrated model steers a pinned session between the host loop
    and its shard count, and an unpinned one (``auto_topology``) over
    every shard count it has a kind for; whatever it picks is the
    oracle's rows."""
    p = platform
    cases = _cases(p)
    truth = [p.oracle(q) for q in cases]
    saved = p.cost_model
    try:
        p.cost_model = _bias_model({
            "knn:host": 5.0, "knn:device": 4.0, "knn:sharded:s2": 1.0,
            "knn:sharded:s8": 0.5, "vr:tile": 1.0, "vr:dense": 2.0})
        # both planned before either runs: an executed plan's samples
        # may refit the model
        pinned = Session(p, shards=2).plan(cases)
        auto = Session(p, auto_topology=True).plan(cases)
        assert pinned.choices["by"] == "cost_model"
        assert pinned.choices["chosen"] == {"device_loop": True,
                                            "shards": 2}
        assert {(c["device_loop"], c["shards"])
                for c in pinned.choices["candidates"]} == {(False, 0),
                                                           (True, 2)}
        assert auto.choices["chosen"] == {"device_loop": True, "shards": 8}
        assert {(c["device_loop"], c["shards"])
                for c in auto.choices["candidates"]} == {
                    (False, 0), (True, 0), (True, 2), (True, 8)}
        assert auto.explain()["shards"] == 8
        for plan, s in ((pinned, 2), (auto, 8)):
            rows, st = plan.execute()
            assert st.shards == s
            _same(rows, truth, s)
        assert p.session().auto_topology
        assert not p.session(shards=0).auto_topology
    finally:
        p.cost_model = saved
        p._sessions.clear()


def test_calibrate_with_shard_counts_fits_sharded_kinds():
    p, _ = _fuzz_platform(seed=3)
    m = p.calibrate(shard_counts=[2, 0], batch=8, repeats=1)
    assert set(m.sweep_s) == {"host", "device", "sharded:s2"}
    assert "knn:sharded:s2" in p.qbs.cost
    assert "knn:sharded:s2" in m.kinds
