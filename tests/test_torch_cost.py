"""The port's calibrated cost model against the JAX package.

The two packages time different machines, so parity is held on the
math, not on timings:

* identical (kind, features, seconds) rings in both ``QBSTable``s give
  the same ``ridge_fit`` weights, ``steady_samples`` trims, fits,
  ``predict`` values (and the ``EXTRAPOLATION_MAX`` decline),
  ``reliable`` gates and ``maybe_refit`` cursor;
* a reference model carried across with ``to_dict`` / ``from_dict``
  (hand-built to force each choice, and one from the reference's own
  calibration sweep) makes the reference's loop choice (``_cost_choice``:
  candidates, predictions, choice), V.R route, beam seeds and
  ``explain()["cost_model"]`` on the same carried platform state;
* an uncalibrated or unreliable model leaves plans, routes and rows
  byte-identical to no model at all.

Predictions are compared for identity: the same float64 numpy math on
the same inputs.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core import qbs as jqbs
from repro.core import query as JQ
from repro.core.lake import MMOTable as JTable
from repro.core.planner import Session as JSession
from repro.core.platform import MQRLD as JMQRLD
from repro_torch.core import cost as tcost
from repro_torch.core import qbs as tqbs
from repro_torch.core import query as TQ
from repro_torch.core.planner import Session as TSession
from repro_torch.core.platform import state_from_numpy
from repro_torch.utils import roofline

from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)

KINDS = ("knn:host", "knn:device", "vr:dense", "vr:tile")


@pytest.fixture(scope="module")
def ref_platform():
    """tests/test_cost.py's platform: 900 x 8 blobs and a price column."""
    rng = np.random.default_rng(3)
    n, d = 900, 8
    centers = rng.normal(size=(5, d)).astype(np.float32) * 7
    lab = rng.integers(0, 5, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    t = (JTable("cost_shop").add_vector("img", vec)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = JMQRLD(t, seed=0)
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p


def _fresh_pair(p):
    """The reference platform with fresh QBS rings and no model, and a
    port platform on its carried state."""
    p.qbs = jqbs.QBSTable()
    p.cost_model = None
    p._sessions.clear()
    return p, state_from_numpy(ref_state_arrays(p), device="cpu")


def _batch(M, t, seed=2):
    """V.K, filtered V.K, a tight V.R (the tile route on its own) and a
    V.R over everything (the dense pass)."""
    rng = np.random.default_rng(seed)
    out = []
    for j, i in enumerate(rng.integers(0, t.n_rows, 8)):
        v = t.vector["img"][i]
        out.append([M.VK.of("img", v, 8),
                    M.And.of(M.NR("price", 20, 80), M.VK.of("img", v, 6)),
                    M.And.of(M.VR.of("img", v, 3.0), M.NR("price", 10, 90)),
                    M.VR.of("img", v, 1e4)][j % 4])
    return out


def _bias_model(cls, err=0.0, **bias_by_kind):
    """A model of package ``cls`` predicting a constant per kind."""
    m = cls()
    for kind, b in bias_by_kind.items():
        kind = kind.replace("_", ":")
        dim = 5 if kind.startswith("vr:") else 7
        m.kinds[kind] = {"w": [float(b)] + [0.0] * (dim - 1), "n": 8,
                         "err": err}
    return m


# ---------------------------------------------------------------------------
# roofline and features
# ---------------------------------------------------------------------------
def test_roofline_peaks_are_the_cards():
    assert roofline.PEAK_FLOPS == {"fp32": 67e12, "bf16": 989e12,
                                   "int8": 1979e12}
    assert roofline.PEAK_BYTES == 3.35e12
    assert roofline.peak_flops("int8") == 1979e12
    assert roofline.peak_flops("fp8") == roofline.PEAK_FLOPS_BF16 == 989e12


@pytest.mark.parametrize("prec,want", [("fp32", 1.0), ("bf16", 0.5),
                                       ("int8", 0.25)])
def test_prec_scale_is_the_byte_ratio(prec, want):
    """The scan kernels are byte-bound: the scale stays the element
    width's ratio, the one the reference's peaks give, not the card's
    tensor-core ratio."""
    assert tcost.prec_scale(prec) == jcost.prec_scale(prec) == want
    assert tcost.prec_scale(prec) != (roofline.peak_flops("fp32")
                                      / roofline.peak_flops(prec)) \
        or prec == "fp32"


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("seed", [None, 3, 40])
def test_plan_features_match_reference(device_loop, seed):
    for prec in ("fp32", "int8"):
        kw = dict(device_loop=device_loop, g=5, k=8, beam=16, tiles=37,
                  cap=64, dim=8, precision=prec, seed=seed)
        f = tcost.knn_plan_features(**kw)
        assert len(f) == tcost.KNN_FEATURE_DIM == jcost.KNN_FEATURE_DIM
        assert f == jcost.knn_plan_features(shards=0, **kw)
    for kind in ("vr:dense", "vr:tile"):
        assert tcost.vr_features(kind, 3, 5, 64, 8, 900) == \
            jcost.vr_features(kind, 3, 5, 64, 8, 900)


# ---------------------------------------------------------------------------
# fit, predict, gates and the refit cursor
# ---------------------------------------------------------------------------
def test_ridge_fit_and_steady_samples_match_reference():
    rng = np.random.default_rng(0)
    X = np.c_[np.ones(30), rng.uniform(0, 10, (30, 3))]
    X = np.r_[X, X[:6]]                      # repeated shapes
    y = X @ [0.1, 0.02, 0.3, 0.0] + rng.uniform(0, 0.01, 36)
    y[:6] += 5.0                             # their first runs' one-off cost
    for lam in (1e-3, 1e-1):
        np.testing.assert_array_equal(tcost.ridge_fit(X, y, lam),
                                      jcost.ridge_fit(X, y, lam))
    for a, b in zip(tcost.steady_samples(X, y), jcost.steady_samples(X, y)):
        np.testing.assert_array_equal(a, b)
    assert len(tcost.steady_samples(X, y)[1]) == 30


def _rings(rng):
    """(kind, features, seconds) samples: a clean linear kind with a few
    outliers (the trimmed refit), one below the sample floor, one with
    stale rows of an older feature length."""
    out = []
    for _ in range(40):
        f = [1.0, *rng.uniform(0, 20, 6)]
        s = 1e-3 + f[1] * 2e-4 + f[2] * 1e-5
        out.append(("knn:device", f, s * (30.0 if rng.random() < 0.1
                                          else 1.0)))
    for _ in range(5):
        out.append(("knn:host", [1.0, *rng.uniform(0, 5, 6)], 0.01))
    for i in range(14):
        f = [1.0, *rng.uniform(0, 9, 4)]
        out.append(("vr:tile", f[:3] if i < 3 else f, 2e-3 + f[2] * 1e-4))
    for _ in range(12):
        f = [1.0, *rng.uniform(0, 9, 4)]
        out.append(("vr:dense", f, rng.uniform(1e-3, 1.0)))   # noise
    return out


def test_fit_predict_and_refit_cursor_match_reference():
    samples = _rings(np.random.default_rng(1))
    jt, tt = jqbs.QBSTable(), tqbs.QBSTable()
    for kind, f, s in samples:
        jt.record_cost(kind, f, s)
        tt.record_cost(kind, f, s)
    for kind in KINDS:
        a, b = tt.cost_samples(kind), jt.cost_samples(kind)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    jm, tm = jcost.CostModel(), tcost.CostModel()
    assert tm.fit_from_qbs(tt) == jm.fit_from_qbs(jt) == \
        ["knn:device", "vr:dense", "vr:tile"]
    assert tm.kinds == jm.kinds
    assert tm._fit_seen == jm._fit_seen == len(samples)
    assert tm.kinds["vr:dense"]["n"] == 10       # trimmed refit
    assert tm.kinds["vr:tile"]["n"] == 11        # stale rows ignored
    for kinds in (("vr:tile",), ("knn:device",), ("knn:host",),
                  ("vr:dense", "vr:tile")):
        assert tm.reliable(*kinds) == jm.reliable(*kinds)
    assert tm.reliable("vr:tile") and not tm.reliable("knn:device")
    assert tm.calibrated() and tm.calibrated("vr:tile") and \
        not tm.calibrated("knn:host", "vr:tile")
    hi = np.asarray(tm.kinds["knn:device"]["hi"])
    for x in (hi * 0.5, hi * 3.9, hi * 4.1, [1.0] * 6):
        assert tm.predict("knn:device", list(x)) == \
            jm.predict("knn:device", list(x))
    assert tm.predict("knn:device", list(hi * 4.1)) is None
    assert tm.predict("knn:device", [1.0] * 6) is None   # shape drift
    assert tm.predict("knn:host", [1.0] * 7) is None     # not fitted
    for i in range(tcost._REFIT_EVERY):
        jt.record_cost("knn:host", [1.0] * 7, 0.01)
        tt.record_cost("knn:host", [1.0] * 7, 0.01)
        last = i == tcost._REFIT_EVERY - 1
        assert tm.maybe_refit(tt) == jm.maybe_refit(jt) == last
    assert tm.kinds == jm.kinds and "knn:host" in tm.kinds


def test_model_round_trips_and_carries_the_references():
    samples = _rings(np.random.default_rng(2))
    jt = jqbs.QBSTable()
    for kind, f, s in samples:
        jt.record_cost(kind, f, s)
    jm = jcost.CostModel()
    jm.fit_from_qbs(jt)
    jm.host = {"cpu_count": 2, "device_count": 1, "backend": "cpu"}
    d = json.loads(json.dumps(jm.to_dict()))
    tm = tcost.CostModel.from_dict(d)
    assert tm.to_dict() == jm.to_dict()
    back = tcost.CostModel.from_dict(json.loads(json.dumps(tm.to_dict())))
    assert back.kinds == tm.kinds and back.host == tm.host
    assert tcost.CostModel.from_dict({}).kinds == {}


def test_host_fingerprint_has_the_references_keys():
    fp = tcost.host_fingerprint("cpu")
    assert set(fp) == set(jcost.host_fingerprint())
    assert fp["backend"] == "cpu" and fp["cpu_count"] >= 1


# ---------------------------------------------------------------------------
# the trust gate
# ---------------------------------------------------------------------------
def _run(pt, batch, model):
    pt.cost_model = model
    sess = TSession(pt)
    plan = sess.plan(batch)
    ex = plan.explain()
    rows, st = plan.execute()
    routes = [k for k, _, _ in st.stage_samples if k.startswith("vr:")]
    return plan, ex, rows, st, routes


@pytest.mark.parametrize("model", ["uncalibrated", "partial", "unreliable"])
def test_untrusted_model_leaves_plans_byte_identical(ref_platform, model):
    """No steering without trust: every choice (loop, seeds, V.R route)
    and every row equal those of a platform with no model."""
    _, pt = _fresh_pair(ref_platform)
    batch = _batch(TQ, pt.table)
    pt.session().plan(batch).execute()          # beam seeds in QBS
    base = _run(pt, batch, None)
    m = {"uncalibrated": tcost.CostModel(),
         # the session default's loop kind and "vr:tile" are missing
         "partial": _bias_model(tcost.CostModel, knn_host=1e-9,
                                vr_dense=1e-9),
         # every kind fitted, but off by more than RELIABLE_ERR
         "unreliable": _bias_model(tcost.CostModel, err=1.5,
                                   knn_host=1e-9, knn_device=10.0,
                                   vr_dense=10.0, vr_tile=1e-9)}[model]
    got = _run(pt, batch, m)
    assert got[0].choices == base[0].choices == {"by": "default"}
    assert got[0].logical == base[0].logical
    assert got[0]._seeds() == base[0]._seeds()
    assert got[4] == base[4]                   # V.R routes taken
    for a, b in zip(got[2], base[2]):
        np.testing.assert_array_equal(a, b)
    for fa, fb in zip(got[1]["fragments"], base[1]["fragments"]):
        assert [v["route"] for v in fa["vr"]] == \
            [v["route"] for v in fb["vr"]]
        assert [k["beam_seed"] for k in fa["knn"]] == \
            [k["beam_seed"] for k in fb["knn"]]
    assert got[3].vr_dense_fallbacks == base[3].vr_dense_fallbacks


# ---------------------------------------------------------------------------
# a reference model carried across makes the reference's choices
# ---------------------------------------------------------------------------
def _same_choices(p, pt, jm):
    """Carry ``jm`` across and hold the port's choices on one batch to the
    reference's: ``_cost_choice``, the plan's seeds, explain()'s
    cost_model block, per-V.R route previews and the routes taken, and
    the rows."""
    tm = tcost.CostModel.from_dict(json.loads(json.dumps(jm.to_dict())))
    p.cost_model, pt.cost_model = jm, tm
    jb, tb = _batch(JQ, p.table), _batch(TQ, pt.table)
    js, ts = JSession(p, interpret=True), TSession(pt)
    jc = js._cost_choice([JQ.normalize(q) for q in jb])
    tc = ts._cost_choice([TQ.normalize(q) for q in tb])
    assert (jc is None) == (tc is None)
    if jc is not None:
        assert tc[0] == jc[0] and jc[1] == 0
        assert tc[1] == jc[2]
    jplan, tplan = js.plan(jb), ts.plan(tb)
    assert tplan.logical.device_loop == jplan.logical.device_loop
    assert tplan._seeds() == jplan._seeds()
    je, te = jplan.explain(), tplan.explain()
    assert te["cost_model"] == je["cost_model"]
    for fa, fb in zip(te["fragments"], je["fragments"]):
        for va, vb in zip(fa["vr"], fb["vr"]):   # observed times differ
            for key in ("predicted_dense_s", "predicted_tile_s", "route"):
                assert va["cost"][key] == vb["cost"][key], key
        assert [k["cost"]["predicted_s"] for k in fa["knn"]] == \
            [k["cost"]["predicted_s"] for k in fb["knn"]]
    jr, jst = jplan.execute()
    tr, tst = tplan.execute()
    assert [k for k, _, _ in tst.stage_samples if k.startswith("vr:")] == \
        [k for k, _, _ in jst.stage_samples if k.startswith("vr:")]
    assert tst.vr_dense_fallbacks == jst.vr_dense_fallbacks
    for q, a, b in zip(tb, tr, jr):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.sort(a), np.sort(pt.oracle(q)))
    return tplan, tst


@pytest.mark.parametrize("case", ["host", "device", "tile", "dense",
                                  "sharded_kind", "seed_costs"])
def test_carried_model_makes_the_references_choices(ref_platform, case):
    p, pt = _fresh_pair(ref_platform)
    for M, plat in ((JQ, p), (TQ, pt)):      # the same beam seeds in QBS
        plat.session().plan(_batch(M, plat.table, seed=5)).execute()
    kw = {"host": dict(knn_host=1e-6, knn_device=10.0),
          "device": dict(knn_host=10.0, knn_device=1e-6),
          "tile": dict(knn_host=10.0, knn_device=1.0, vr_dense=10.0,
                       vr_tile=1e-6),
          "dense": dict(knn_host=10.0, knn_device=1.0, vr_dense=1e-6,
                        vr_tile=10.0),
          "sharded_kind": dict(knn_host=10.0, knn_device=1.0,
                               **{"knn:sharded:s2": 1e-9}),
          "seed_costs": dict(knn_host=1e-3, knn_device=1e-3)}[case]
    jm = _bias_model(jcost.CostModel, **kw)
    if case == "seed_costs":     # the scan term prices wider seeded beams
        for kind in ("knn:host", "knn:device"):
            jm.kinds[kind]["w"][2] = 1e-3
    try:
        plan, st = _same_choices(p, pt, jm)
    finally:
        p.cost_model = None
    if case != "seed_costs":
        assert plan.choices["by"] == "cost_model"
        assert plan.logical.device_loop is (case != "host")
    if case in ("tile", "dense"):      # the V.R group's route, steered
        kinds = {k for k, _, _ in st.stage_samples if k.startswith("vr:")}
        assert kinds == {f"vr:{case}"}


def test_carried_calibrated_reference_model(ref_platform):
    """The reference's own calibration sweep, carried across: the same
    choices, routes and rows."""
    p, pt = _fresh_pair(ref_platform)
    jm = p.calibrate(batch=4, repeats=1, seed=1)
    assert jm.calibrated()
    pt.qbs = tqbs.QBSTable()
    for kind, ring in p.qbs.cost.items():    # the same refit feed
        for f, s in ring:
            pt.qbs.record_cost(kind, f, s)
    pt.qbs.convergence = {k: list(v) for k, v in p.qbs.convergence.items()}
    tm = tcost.CostModel.from_dict(jm.to_dict())
    tm._fit_seen = jm._fit_seen
    assert tm.kinds == jm.kinds
    _same_choices(p, pt, jm)


def test_calibrate_on_the_cpu(ref_platform):
    """``calibrate()`` on the port's CPU platform fits every kind it
    observed with enough samples, records where it ran, and rows stay the
    oracle's under the fitted model; executed plans refit it online."""
    _, pt = _fresh_pair(ref_platform)
    m = pt.calibrate(batch=4, repeats=1, seed=1)
    assert m is pt.cost_model
    seen = {k for k in pt.qbs.cost
            if len(pt.qbs.cost_samples(k)[1]) >= tcost._MIN_SAMPLES}
    # at 900 rows of 128-row tiles even the anchored V.R batches cover
    # more than half the table and take the dense pass, as in the
    # reference's sweep: "vr:tile" is not observed here
    assert set(m.kinds) == seen == set(pt.qbs.cost) == \
        {"knn:host", "knn:device", "vr:dense"}
    assert m.host["backend"] == "cpu"
    assert set(m.sweep_s) == {"host", "device"} and min(
        m.sweep_s.values()) > 0
    assert m._fit_seen == pt.qbs.cost_total
    batch = _batch(TQ, pt.table, seed=7)
    sess = pt.session()
    seen0 = m._fit_seen
    while pt.qbs.cost_total - seen0 < tcost._REFIT_EVERY:
        rows, _ = sess.plan(batch).execute()
        for q, r in zip(batch, rows):
            np.testing.assert_array_equal(np.sort(r), np.sort(pt.oracle(q)))
    assert m._fit_seen == pt.qbs.cost_total    # refit online
