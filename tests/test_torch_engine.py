"""The port's engine and the whole slice against the JAX package.

* The reference's prepared state, carried across as plain numpy arrays
  (``state_from_numpy``), serves the port's ``HybridEngine``: on both
  beam loops, every query's rows and the engine's scan counters equal
  the reference engine's (which runs its Pallas top-k in interpret
  mode, its default on the CPU).
* The whole slice: the port's own ``prepare()`` + ``session().plan()
  .execute()`` returns the reference's rows and the oracle's.

Rows and counters are compared exactly.
"""
import copy

import numpy as np
import pytest
import torch

from repro.core import query as JQ
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro.core.platform import _copy_tree
from repro_torch.core import engine as teng
from repro_torch.core import query as TQ
from repro_torch.core.engine import HybridEngine
from repro_torch.core.lake import MMOTable as TTable
from repro_torch.core.platform import MQRLD, state_from_numpy
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

N, D, BATCH = 2400, 8, 24
STAT_KEYS = ("knn_rounds", "knn_buckets", "rows_scanned",
             "vr_tiles_scanned", "vr_tiles_pruned", "vr_dense_fallbacks",
             "predicate_buckets")


def _data(seed=0):
    """12-centre Gaussian blobs plus a uniform ``price`` column, drawn
    the way benchmarks/bench_engine.py draws its table."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, D)).astype(np.float32) * 6
    cat = rng.integers(0, 12, N)
    vec = (centers[cat] + rng.normal(size=(N, D))).astype(np.float32)
    price = rng.uniform(0, 100, N).astype(np.float32)
    return vec, price


def _batch(M, vecs, radius, seed=1):
    """The four paper archetypes round-robin: VK, NR+VK, VR+NR, VR+VK."""
    rng = np.random.default_rng(seed)
    out = []
    for j, i in enumerate(rng.integers(0, len(vecs), BATCH)):
        v = vecs[i]
        out.append([
            M.VK.of("v", v, 20),
            M.And.of(M.NR("price", 25, 75), M.VK.of("v", v, 20)),
            M.And.of(M.VR.of("v", v, radius), M.NR("price", 20, 80)),
            M.And.of(M.VR.of("v", v, radius), M.VK.of("v", v, 20)),
        ][j % 4])
    return out


def ref_state_arrays(p) -> dict:
    """A prepared reference platform's state as plain numpy arrays."""
    a = {"name": np.asarray(p.table.name)}
    for pre, t in (("raw", p.raw_table), ("table", p.table)):
        for k, v in t.numeric.items():
            a[f"{pre}/num/{k}"] = v
        for k, v in t.vector.items():
            a[f"{pre}/vec/{k}"] = v
    for k in ("bucket_id", "bucket_starts", "row_ids"):
        a[f"table/{k}"] = getattr(p.table, k)
    tr = p.tree
    for k in ("centroid", "radius", "parent", "is_leaf", "bucket_start",
              "bucket_end", "lm_a", "lm_b", "depth"):
        a[f"tree/{k}"] = getattr(tr, k)
    a["tree/children_ptr"] = np.cumsum(
        [0] + [len(c) for c in tr.children]).astype(np.int64)
    a["tree/children_idx"] = np.asarray(
        [c for cs in tr.children for c in cs], np.int64)
    for f in ("vec_centroid", "vec_radius", "num_lo", "num_hi"):
        for k, v in getattr(p.meta, f).items():
            a[f"meta/{f}/{k}"] = v
    for k in ("r", "s", "mean"):
        a[f"transform/{k}"] = getattr(p.transform, k)
    a["enhanced"] = p.enhanced
    for c, span in p.layout.items():
        a[f"layout/{c}"] = np.asarray(span, np.int64)
    return a


@pytest.fixture(scope="module")
def pair():
    """(reference platform, port platform on the carried state, radius)."""
    vec, price = _data()
    p = JMQRLD(JTable("t").add_vector("v", vec).add_numeric("price", price),
               seed=0)
    p.prepare(min_leaf=32, max_leaf=256)
    pt = state_from_numpy(ref_state_arrays(p), device="cpu")
    # radius from the data: about the 30th-nearest-neighbour distance
    s = vec[:200]
    d = np.sqrt(((s[:, None, :] - vec[None, :, :]) ** 2).sum(-1))
    radius = float(np.round(np.median(np.sort(d, axis=1)[:, 30]), 2))
    return p, pt, radius


def test_state_carries_across(pair):
    p, pt, _ = pair
    assert pt.tree.children == p.tree.children
    np.testing.assert_array_equal(pt.table.row_ids, p.table.row_ids)
    np.testing.assert_array_equal(pt.table.vector["v"], p.table.vector["v"])
    assert isinstance(pt.engine(), HybridEngine)


@pytest.mark.parametrize("device_loop", [True, False])
def test_engine_on_carried_state_matches_reference(pair, device_loop):
    """Two batches (the second with QBS beam seeds from the first): rows
    per query and the scan counters equal the reference engine's."""
    p, pt, radius = pair
    tab = p.table.vector["v"]
    for seed in (1, 2):
        jq, tq = _batch(JQ, tab, radius, seed), _batch(TQ, tab, radius, seed)
        want, ws = p.session().plan(jq, device_loop=device_loop).execute()
        got, gs = pt.session().plan(tq, device_loop=device_loop).execute()
        for q, a, b in zip(tq, want, got):
            np.testing.assert_array_equal(a, b, err_msg=repr(q)[:80])
            np.testing.assert_array_equal(b, pt.oracle(q))
        for key in STAT_KEYS:
            assert getattr(gs, key) == getattr(ws, key), key
        assert gs.knn_group_widths == ws.knn_group_widths
        assert gs.knn_exact_fallbacks == 0   # every re-rank certified
    if device_loop:   # the host loop always takes the dense V.R pass
        assert gs.vr_tiles_scanned + gs.vr_dense_fallbacks > 0


def test_whole_slice_matches_reference_and_oracle(pair):
    """Port prepare() + session().plan().execute() on the same raw table
    returns the reference's rows and the oracle's, on both loops."""
    p, _, radius = pair
    vec, price = _data()
    pt = MQRLD(TTable("t").add_vector("v", vec).add_numeric("price", price),
               seed=0, device="cpu")
    rep = pt.prepare(min_leaf=32, max_leaf=256)
    assert rep.n_leaves > 1
    np.testing.assert_array_equal(np.sort(pt.table.row_ids),
                                  np.arange(N))
    sess = pt.session()
    for device_loop in (True, False):
        tq = _batch(TQ, pt.table.vector["v"], radius, seed=3)
        got, _ = sess.plan(tq, device_loop=device_loop).execute()
        # the reference answers the same queries over its own layout:
        # compare in raw row ids
        jq = _batch(JQ, pt.table.vector["v"], radius, seed=3)
        want, _ = p.session().plan(jq, device_loop=device_loop).execute()
        for q, g, w in zip(tq, got, want):
            np.testing.assert_array_equal(g, pt.oracle(q))
            gi, wi = pt.table.row_ids[g], p.table.row_ids[w]
            if isinstance(q, TQ.VK):
                np.testing.assert_array_equal(gi, wi)
            else:
                np.testing.assert_array_equal(np.sort(gi), np.sort(wi))
    ex = sess.plan(tq).explain()
    assert ex["cache"] == "hit" and ex["n_scalar"] == 0
    assert {f["path"] for f in ex["fragments"]} == {"device-loop"}


@pytest.mark.parametrize("k", [250, 256])
@pytest.mark.parametrize("device_loop", [True, False])
def test_large_k_rows_equal_oracle(pair, k, device_loop):
    """Large k keeps the scan's full re-rank margin (k + 8 candidates),
    and the rows are the oracle's."""
    _, pt, _ = pair
    tab = pt.table.vector["v"]
    qs = [TQ.VK.of("v", tab[i], k) for i in (0, 700, 1900)]
    qs.append(TQ.And.of(TQ.NR("price", 25, 75), TQ.VK.of("v", tab[5], k)))
    got, _ = pt.session().plan(qs, device_loop=device_loop).execute()
    for q, g in zip(qs, got):
        assert len(g) == k
        np.testing.assert_array_equal(g, pt.oracle(q))


@pytest.mark.parametrize("device_loop", [True, False])
def test_k300_rows_equal_reference_engine(pair, device_loop):
    """A V.K above the kernels' old limit of 256 (no limit now): the port's
    engine returns the reference engine's rows, and the oracle's."""
    p, pt, _ = pair
    tab = p.table.vector["v"]
    jq = [JQ.VK.of("v", tab[i], 300) for i in (3, 1500)]
    jq.append(JQ.And.of(JQ.NR("price", 25, 75), JQ.VK.of("v", tab[9], 300)))
    tq = [TQ.VK.of("v", tab[i], 300) for i in (3, 1500)]
    tq.append(TQ.And.of(TQ.NR("price", 25, 75), TQ.VK.of("v", tab[9], 300)))
    want, _ = p.session().plan(jq, device_loop=device_loop).execute()
    got, _ = pt.session().plan(tq, device_loop=device_loop).execute()
    for q, a, b in zip(tq, want, got):
        assert len(b) == 300
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, pt.oracle(q))


@pytest.mark.parametrize("device_loop", [True, False])
def test_expansion_misorder_takes_exact_pass(pair, device_loop):
    """The same state shifted far from the origin: the fp32 expansion's
    error swamps the gaps between neighbours, so its order differs from
    the oracle's at the top-k boundary. No re-rank can be certified and
    every job takes the widening pass, which returns the oracle's rows."""
    p, _, _ = pair
    arrays = ref_state_arrays(p)
    for key in ("raw/vec/v", "table/vec/v", "meta/vec_centroid/v"):
        arrays[key] = arrays[key] + np.float32(3000.0)
    pt = state_from_numpy(arrays, device="cpu")
    vec = pt.table.vector["v"]
    idx = [0, 411, 977, 1500, 2222]
    qs = [TQ.VK.of("v", vec[i], 20) for i in idx]
    qs += [TQ.And.of(TQ.NR("price", 25, 75), TQ.VK.of("v", vec[i], 20))
           for i in idx]
    got, st = pt.session().plan(qs, device_loop=device_loop).execute()
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, pt.oracle(q))
    assert st.knn_exact_fallbacks == st.knn_jobs == len(qs)
    _, order = tref.stable_topk(tref.pairwise_sq_l2(
        torch.from_numpy(vec[idx]), torch.from_numpy(vec)), 20)
    assert any(not np.array_equal(o, pt.oracle(q))
               for o, q in zip(order.numpy(), qs))


@pytest.mark.parametrize("case,want", [
    ("wide_margin", True), ("thin_expansion_margin", False),
    ("expansion_margin_just_enough", True), ("tile_bound_near", False),
    ("fewer_than_k_all_scanned", True), ("fewer_than_k_tiles_left", False),
    ("refuted_bound_far", True), ("refuted_bound_near", False),
    ("refuted_quant_bound_near", True),
    ("refuted_quant_bound_within_rounding", False)])
def test_rerank_certificate(case, want):
    """The proof's cases at d=512 with |q|^2, max|p|^2 and max|c|^2 all
    2e4 (expansion error bound about 4.9): a candidate set is complete
    only when the k-th exact distance (800 here) clears the rows the
    kernel ranked past the last slot (m - 4.9), the tiles that may hold
    left-out rows (a bound of 28.3 reaches only 28.1^2 = 791) and the
    candidates the mixed-precision rescue refuted. A refuted bound that
    came from a tile's ball takes the tile bound's corrections (801 is
    not enough); one from the quantized scan is already a lower bound on
    the exact distance and takes off only roundings (801 is enough,
    800.01 is not)."""
    t_k, m, nxt, refuted_q, refuted_b = {
        "wide_margin": (800.0, 830.0, 160.0, np.inf, np.inf),
        "thin_expansion_margin": (800.0, 803.0, np.inf, np.inf, np.inf),
        "expansion_margin_just_enough": (800.0, 806.0, np.inf, np.inf,
                                         np.inf),
        "tile_bound_near": (800.0, 830.0, 28.3, np.inf, np.inf),
        "fewer_than_k_all_scanned": (np.inf,) * 5,
        "fewer_than_k_tiles_left": (np.inf, np.inf, 50.0, np.inf, np.inf),
        "refuted_bound_far": (800.0, 830.0, 160.0, 900.0, 900.0),
        "refuted_bound_near": (800.0, 830.0, 160.0, 900.0, 801.0),
        "refuted_quant_bound_near": (800.0, 830.0, 160.0, 801.0, 900.0),
        "refuted_quant_bound_within_rounding": (800.0, 830.0, 160.0,
                                                800.01, np.inf)}[case]
    assert teng._rerank_certified(t_k, m, nxt, 2e4, 512, 2e4, 2e4,
                                  30.0, refuted_q, refuted_b) is want


def test_unplannable_query_takes_the_scalar_path(pair):
    """A V.K under an Or under an And is not plannable for the engine:
    the plan sends it down the scalar path, with the oracle's rows and
    the reference planner's."""
    p, pt, _ = pair
    v = pt.table.vector["v"][0]

    def q(M):
        return M.And.of(M.NR("price", 0, 50),
                        M.Or.of(M.VK.of("v", v, 3), M.NR("price", 0, 10)))
    plan = pt.session().plan([q(TQ)])
    assert plan.explain()["n_scalar"] == 1
    got, st = plan.execute()
    want, _ = p.session().plan([q(JQ)]).execute()
    assert st.queries == 1
    np.testing.assert_array_equal(got[0], pt.oracle(q(TQ)))
    np.testing.assert_array_equal(got[0], want[0])


def test_engine_cache_keeps_four_in_lru_order(pair):
    """``MQRLD.engine()`` keeps at most four engines, least recently used
    out first, and re-inserts an engine on a hit. A fifth configuration
    evicts the first; asking for the first again rebuilds it, with the
    same rows as before."""
    p, _, radius = pair
    pt = state_from_numpy(ref_state_arrays(p), device="cpu")
    batch = _batch(TQ, pt.table.vector["v"], radius)
    first = pt.engine(precision="fp32")
    rows, _ = pt.session(precision="fp32").plan(batch).execute()
    keys = [(16, 128, "fp32"), (8, 128, "fp32"), (16, 64, "fp32"),
            (32, 128, "fp32"), (16, 128, "int8")]
    for beam, tile, prec in keys[1:]:
        pt.engine(beam=beam, tile=tile, precision=prec)
    assert list(pt._engines) == keys[1:]
    pt.engine(beam=8, tile=128, precision="fp32")        # a hit
    assert list(pt._engines) == keys[2:] + [keys[1]]
    again, _ = pt.session(precision="fp32").plan(batch).execute()
    assert list(pt._engines) == keys[3:] + [keys[1], keys[0]]
    assert pt.engine(precision="fp32") is not first
    for a, b in zip(rows, again):
        np.testing.assert_array_equal(a, b)


def test_carried_state_folds_like_reference(pair):
    """A platform carried across by ``state_from_numpy`` (its enhanced
    features and column layout included) folds the same appended rows
    into the reference's tree, layout and leaf metadata, array for array,
    and its scalar path then answers as the reference's and the
    oracle."""
    p, _, _ = pair
    jp = copy.copy(p)            # the module's reference stays unfolded
    jp.tree = _copy_tree(p.tree)
    jp._engines, jp._sessions, jp._oracle_cache = {}, {}, {}
    pt = state_from_numpy(ref_state_arrays(p), device="cpu")
    rng = np.random.default_rng(7)
    tab = p.table.vector["v"]
    new = {"numeric": {"price": rng.uniform(0, 100, 40).astype(np.float32)},
           "vector": {"v": (tab[rng.integers(0, N, 40)] + 0.5 * rng.normal(
               size=(40, D))).astype(np.float32)}}
    for plat in (jp, pt):
        plat.append(numeric=new["numeric"], vector=new["vector"], fold=False)
    assert jp.fold() == pt.fold() == 40
    for k in ("bucket_start", "bucket_end", "radius", "lm_a", "lm_b"):
        np.testing.assert_array_equal(getattr(pt.tree, k),
                                      getattr(jp.tree, k), err_msg=k)
    np.testing.assert_array_equal(pt.table.row_ids, jp.table.row_ids)
    np.testing.assert_array_equal(pt.table.vector["v"], jp.table.vector["v"])
    np.testing.assert_array_equal(pt.enhanced, jp.enhanced)
    for f in ("vec_centroid", "vec_radius", "num_lo", "num_hi"):
        for k, v in getattr(jp.meta, f).items():
            np.testing.assert_array_equal(getattr(pt.meta, f)[k], v)
    for i in (0, 2400, 2439):
        tq = TQ.And.of(TQ.NR("price", 10, 90),
                       TQ.VK.of("v", pt.table.vector["v"][i], 9))
        jq = JQ.And.of(JQ.NR("price", 10, 90),
                       JQ.VK.of("v", pt.table.vector["v"][i], 9))
        got, _ = pt.execute(tq, record=False)
        np.testing.assert_array_equal(got, jp.execute(jq, record=False)[0])
        np.testing.assert_array_equal(got, pt.oracle(tq))
