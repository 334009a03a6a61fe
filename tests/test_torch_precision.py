"""The port's mixed-precision tile scan against the JAX package.

* Planes (``utils.quant.plan_tiles``) and the query quantization on the
  same numpy inputs as the reference's.
* The plain ``quant_lb2`` against the reference's plain version and its
  Pallas kernel (interpret mode), and the conservative-bound contract
  (lb2 <= exact squared distance) checked directly.
* ``ops.topk_l2_masked_mp`` against the reference's on its edge cases.
* The engine on the reference's prepared state, both loops, int8 and
  bf16: rows equal to the reference engine's and to fp32, and its
  reduced-precision counters.
* The session's ``precision``: plan caches, ``explain()``, the
  ``MQRLD_PRECISION`` override.

Tolerances, with their reasons:
* int8 planes, codes, scales, query planes and int8 bounds of the plain
  version: bit-equal to the reference's plain version (same numpy for the
  planes; an exact integer cross term and the same order of fp32
  operations for the bounds). Against the Pallas kernel in interpret
  mode, which fuses its epilogue differently, int8 bounds agree within
  1e-6 * (|q|^2 + |p|^2) + 1e-5.
* bf16: codes bit-equal; the query's squared norm and error bound are
  fp32 sums of D terms whose order differs between XLA and torch, so they
  agree within 2 D u relative (u = 2^-24); bounds within
  1e-6 * (|q|^2 + |p|^2) + 1e-5.
* top-k ids exact; squared distances rtol=1e-5, atol=1e-5 (fp32
  summation order).
* Engine rows exact. ``mp_scanned`` equals the reference's: it counts the
  candidate rows of the rounds, which follow from the stopping rule
  alone. ``mp_rescued`` equals it for int8, whose bounds agree bit for
  bit with the reference's plain version; the reference engine runs the
  Pallas kernel, whose bounds differ in the last bits, and bf16 bounds
  differ in the last bits too, so an fp32 rescue pick at near-equal
  bounds may land on another candidate: bf16 counts agree within 2% of
  the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import query as JQ
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_topk import quant_lb2_pallas
from repro.utils import quant as jquant
from repro_torch.core import query as TQ
from repro_torch.core.engine import EnginePlan
from repro_torch.core.platform import state_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.utils import quant as tquant
from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)

PRECISIONS = ("int8", "bf16")
RTOL = ATOL = 1e-5
U32 = 2.0 ** -24


def _tiles(seed=0, t=7, cap=16, d=37):
    """Tiles with the planes' edge cases: an all-zero tile (the int8
    scale floors), a constant tile, padding slots holding junk."""
    rng = np.random.default_rng(seed)
    tiles = (rng.normal(size=(t, cap, d)) * rng.uniform(0.5, 20)
             ).astype(np.float32)
    valid = rng.random((t, cap)) < 0.8
    tiles[2] = 0.0
    tiles[3] = 2.5
    tiles[4, ~valid[4]] = 40.0
    return tiles, valid


def _bits(x):
    """numpy view of a plane for bit comparison (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_planes_bit_equal_to_reference(precision, seed):
    tiles, valid = _tiles(seed)
    want = jquant.plan_tiles(tiles, valid, precision)
    got = tquant.plan_tiles(tiles, valid, precision)
    for field in tquant.TilePlanes._fields:
        w, g = _bits(getattr(want, field)), _bits(getattr(got, field))
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    if precision == "int8":   # the junk in padding slots stayed out
        assert float(got.scale[4]) <= np.abs(
            tiles[4][valid[4]]).max() / 127 + 1e-6


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantize_query_matches_reference(precision):
    q = (np.random.default_rng(3).normal(size=(9, 37)) * 3
         ).astype(np.float32)
    q[4] = 0.0                                     # the scale floors
    want = [np.asarray(x) for x in jquant.quantize_query(jnp.asarray(q),
                                                         precision)]
    got = tquant.quantize_query(torch.from_numpy(q), precision)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    if precision == "int8":
        for w, g in zip(want[2:], got[2:]):
            np.testing.assert_array_equal(g.numpy(), w)
    else:
        for w, g in zip(want[2:], got[2:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=2 * 37 * U32,
                                       atol=0)


def _lb2_case(precision, d, seed=0):
    rng = np.random.default_rng(seed)
    g, t, cap = 6, 8, 16
    tiles = (rng.normal(size=(t, cap, d)) * 5).astype(np.float32)
    tv = np.ones((t, cap), bool)
    tv[-1, 5:] = False
    q = (rng.normal(size=(g, d)) * 5).astype(np.float32)
    q[1] = tiles[0, 3]                        # exact distance 0
    sel = np.stack([rng.permutation(t) for _ in range(g)])
    c = t * cap
    valid = (rng.random((g, c)) < 0.8) & tv[sel].reshape(g, c)
    valid[0] = False                          # an all-masked row
    jp = jquant.plan_tiles(tiles, tv, precision)
    codes = np.asarray(jp.data)[sel].reshape(g, c, d)
    cs = np.repeat(jp.scale[sel], cap, axis=1)
    cp = jp.ppq[sel].reshape(g, c)
    ce = np.repeat(jp.eps[sel], cap, axis=1)
    tp = tquant.plan_tiles(tiles, tv, precision)
    tcodes = tp.data[torch.from_numpy(sel)].reshape(g, c, d)
    exact = ((tiles[sel].reshape(g, c, d).astype(np.float64)
              - q[:, None, :]) ** 2).sum(-1)
    jargs = [jnp.asarray(x) for x in (q, codes, cs, cp, ce, valid)]
    targs = [torch.from_numpy(q), tcodes] + [
        torch.from_numpy(x) for x in (cs, cp, ce, valid)]
    mag = (q.astype(np.float64) ** 2).sum(1)[:, None] + cp
    return jargs, targs, valid, exact, mag


@pytest.mark.parametrize("d", [10, 64])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_quant_lb2_plain_matches_reference(precision, d):
    jargs, targs, valid, exact, mag = _lb2_case(precision, d)
    want = np.asarray(jref.quant_lb2(*jargs, precision=precision))
    pal = np.asarray(quant_lb2_pallas(*jargs, precision=precision,
                                      interpret=True))
    got = tops.quant_lb2(*targs, precision=precision).numpy()
    assert (np.isinf(got) == ~valid).all()
    fin = valid
    tol = 1e-6 * mag[fin] + 1e-5
    if precision == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got[fin] - want[fin]) <= tol).all()
    assert (np.abs(got[fin] - pal[fin]) <= tol).all()
    # the conservative-bound contract, against the exact distance
    assert (got[fin] <= exact[fin]).all()
    assert (got[fin] > 0).mean() > 0.5          # and it is not vacuous


# ---------------------------------------------------------------------------
# ops.topk_l2_masked_mp: the cases of tests/test_kernels.py's mp section
# ---------------------------------------------------------------------------
def _mp_case(kind, seed=0):
    rng = np.random.default_rng(seed)
    kth0 = None
    if kind == "all_masked":
        g, t, cap, d, k = 3, 6, 16, 8, 5
        tiles = rng.normal(size=(t, cap, d)).astype(np.float32) * 3
        tv = np.ones((t, cap), bool)
        sel = np.tile(np.arange(4), (g, 1))
        valid = np.ones((g, 4 * cap), bool)
        valid[0] = False
        valid[2, cap:] = False
        q = rng.normal(size=(g, d)).astype(np.float32)
    elif kind == "duplicates_at_boundary":
        g, t, cap, d, k = 2, 4, 8, 4, 5
        base = rng.integers(-8, 9, size=(cap, d)).astype(np.float32)
        tiles = np.stack([base, base,
                          rng.integers(-8, 9, size=(cap, d)
                                       ).astype(np.float32),
                          np.zeros((cap, d), np.float32)])
        tv = np.ones((t, cap), bool)
        q = rng.integers(-8, 9, size=(g, d)).astype(np.float32)
        sel = np.tile(np.arange(t), (g, 1))
        valid = np.ones((g, t * cap), bool)
    elif kind in ("k_above_survivors", "k_above_survivors_kth0"):
        g, t, cap, d, k = 2, 3, 8, 6, 20
        tiles = rng.normal(size=(t, cap, d)).astype(np.float32)
        tv = np.ones((t, cap), bool)
        q = rng.normal(size=(g, d)).astype(np.float32)
        sel = np.tile(np.arange(2), (g, 1))
        valid = np.zeros((g, 2 * cap), bool)
        valid[0, :7] = True
        valid[1, :1] = True
        if kind.endswith("kth0"):   # a tight carry: the true kth
            gath = tiles[sel].reshape(g, -1, d)
            wd, _ = jref.topk_l2_masked(jnp.asarray(q), jnp.asarray(gath),
                                        jnp.asarray(valid), k)
            kth0 = np.asarray(wd)[:, -1].astype(np.float32)
    elif kind == "constant_tiles":
        g, t, cap, d, k = 2, 3, 8, 5, 6
        tiles = np.zeros((t, cap, d), np.float32)
        tiles[1] = 2.5
        tiles[2] = rng.normal(size=(cap, d)).astype(np.float32)
        tv = np.ones((t, cap), bool)
        q = rng.normal(size=(g, d)).astype(np.float32)
        sel = np.tile(np.arange(t), (g, 1))
        valid = np.ones((g, t * cap), bool)
    else:   # "wide": several rescue iterations, ragged selections
        g, t, cap, d, k = 4, 20, 32, 16, 20
        tiles = rng.normal(size=(t, cap, d)).astype(np.float32) * 3
        tv = np.ones((t, cap), bool)
        sel = np.stack([rng.permutation(t)[:10] for _ in range(g)])
        valid = rng.random((g, 10 * cap)) < 0.9
        q = rng.normal(size=(g, d)).astype(np.float32) * 3
    return tiles, tv, q, sel.astype(np.int32), valid, k, kth0


@pytest.mark.parametrize("kind", ["all_masked", "duplicates_at_boundary",
                                  "k_above_survivors",
                                  "k_above_survivors_kth0",
                                  "constant_tiles", "wide"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_mp_topk_matches_reference(kind, precision):
    tiles, tv, q, sel, valid, k, kth0 = _mp_case(kind)
    jp = tuple(jnp.asarray(np.asarray(x))
               for x in jquant.plan_tiles(tiles, tv, precision))
    wd, wi, wr = jops.topk_l2_masked_mp(
        jnp.asarray(q), jnp.asarray(sel), jnp.asarray(valid),
        jnp.asarray(tiles), *jp, k,
        kth0=None if kth0 is None else jnp.asarray(kth0),
        precision=precision, interpret=True)
    tp = tquant.plan_tiles(tiles, tv, precision)
    gd, gi, gr, refuted = tops.topk_l2_masked_mp(
        torch.from_numpy(q), torch.from_numpy(sel).long(),
        torch.from_numpy(valid), torch.from_numpy(tiles), *tp, k,
        kth0=None if kth0 is None else torch.from_numpy(kth0),
        precision=precision)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    fin = np.isfinite(np.asarray(wd))
    assert (np.isfinite(gd.numpy()) == fin).all()
    np.testing.assert_allclose(gd.numpy()[fin], np.asarray(wd)[fin],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    # and the fp32 scan over the same gathered candidates
    gath = tiles[sel].reshape(len(q), -1, tiles.shape[-1])
    _, fi = jref.topk_l2_masked(jnp.asarray(q), jnp.asarray(gath),
                                jnp.asarray(valid), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(fi))
    # a candidate is refuted only by a bound strictly above the running
    # kth (or the carry's): the least refuted bound lies above it; with
    # no ball bounds given every bound is the quantized scan's
    kth = gd[:, -1].double()
    if kth0 is not None:
        kth = torch.minimum(kth, torch.from_numpy(kth0).double())
    assert refuted.shape == (len(q), 2)
    assert bool(((refuted[:, 0].double() > kth)
                 | torch.isinf(refuted[:, 0])).all())
    assert bool(torch.isinf(refuted[:, 1]).all())


def test_mp_k_rescue_ranks_deeper_with_the_same_work():
    """``k_rescue``: output k plus a margin while refuting at the
    stopping rank, as the engine runs it. The first k_rescue rows and
    the rescue counts are those of a call at k = k_rescue."""
    tiles, tv, q, sel, valid, _, _ = _mp_case("wide")
    tp = tquant.plan_tiles(tiles, tv, "int8")
    args = (torch.from_numpy(q), torch.from_numpy(sel).long(),
            torch.from_numpy(valid), torch.from_numpy(tiles), *tp)
    d1, i1, r1, f1 = tops.topk_l2_masked_mp(*args, 12, precision="int8")
    d2, i2, r2, f2 = tops.topk_l2_masked_mp(*args, 20, precision="int8",
                                            k_rescue=12)
    assert torch.equal(i2[:, :12], i1) and torch.equal(r2, r1)
    assert torch.equal(f2, f1)


def test_mp_refuted_bounds_split_by_source():
    """The least refuted bound comes back per source: column 0 over the
    candidates whose bound is the quantized scan's, column 1 over those
    a larger ball bound ``lb2`` set (the certificate corrects only
    those for the ball's rounding)."""
    tiles, tv, q, sel, valid, k, _ = _mp_case("wide")
    tp = tquant.plan_tiles(tiles, tv, "int8")
    args = (torch.from_numpy(q), torch.from_numpy(sel).long(),
            torch.from_numpy(valid), torch.from_numpy(tiles), *tp)
    *_, none = tops.topk_l2_masked_mp(*args, k, precision="int8")
    *_, zero = tops.topk_l2_masked_mp(
        *args, k, lb2=torch.zeros(valid.shape), precision="int8")
    assert torch.equal(zero, none) and bool(torch.isinf(none[:, 1]).all())
    assert bool(torch.isfinite(none[:, 0]).any())
    # every ball bound above every quantized one: the rescue scores one
    # batch of R candidates and refutes the rest by their ball bounds
    big = torch.full(valid.shape, 1e30)
    *_, ball = tops.topk_l2_masked_mp(*args, k, lb2=big, precision="int8")
    assert bool(torch.isinf(ball[:, 0]).all())
    assert torch.equal(ball[:, 1], torch.full((len(q),), 1e30))


# ---------------------------------------------------------------------------
# the engine on carried-over state (tests/test_precision.py's fixture)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    n, d = 1800, 10
    centers = rng.normal(size=(6, d)).astype(np.float32) * 7
    lab = rng.integers(0, 6, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    aud = rng.normal(size=(n, 6)).astype(np.float32)
    t = (JTable("prec_shop").add_vector("img", vec).add_vector("audio", aud)
         .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))
    p = JMQRLD(t, seed=0)
    p.prepare(min_leaf=16, max_leaf=128, dpc_max_clusters=6)
    return p, state_from_numpy(ref_state_arrays(p), device="cpu")


def _cases(M, tab):
    v1 = tab.vector["img"][10]
    v2 = tab.vector["audio"][10]
    return [
        M.VK.of("img", v1, 12),
        M.And.of(M.NR("price", 20, 80), M.VK.of("img", v1, 10)),
        M.VR.of("img", v1, 3.5),
        M.And.of(M.VR.of("img", v1, 5.0), M.VK.of("img", v1, 10)),
        M.Or.of(M.NR("price", 0, 5), M.VR.of("img", v1, 2.0)),
        M.And.of(M.NR("price", 40, 41), M.VK.of("img", v1, 50)),
        M.And.of(M.VR.of("audio", v2, 4.0), M.VK.of("audio", v2, 7)),
        M.VK.of("img", tab.vector["img"][777], 300),
    ]


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_mp_rows_and_counters_match_reference(pair, device_loop,
                                                     precision):
    p, pt = pair
    jc, tc = _cases(JQ, p.table), _cases(TQ, pt.table)
    want, ws = p.session(device_loop=device_loop,
                         precision=precision).execute(jc)
    got, gs = pt.session(device_loop=device_loop,
                         precision=precision).execute(tc)
    fp32, fs = pt.session(device_loop=device_loop,
                          precision="fp32").execute(tc)
    for q, a, b, c in zip(tc, want, got, fp32):
        np.testing.assert_array_equal(b, a, err_msg=repr(q)[:80])
        np.testing.assert_array_equal(b, c, err_msg=repr(q)[:80])
        np.testing.assert_array_equal(b, pt.oracle(q))
    assert gs.mp_scanned == ws.mp_scanned > 0
    assert gs.rows_scanned == ws.rows_scanned
    if precision == "int8":
        assert gs.mp_rescued == ws.mp_rescued
    else:
        assert abs(gs.mp_rescued - ws.mp_rescued) <= 0.02 * ws.mp_rescued
    assert 0 < gs.mp_rescued <= gs.mp_scanned
    assert fs.mp_scanned == fs.mp_rescued == 0
    assert gs.knn_exact_fallbacks == 0


def test_explain_reports_precision_and_rescue(pair):
    _, pt = pair
    cases = _cases(TQ, pt.table)
    sess = pt.session(precision="int8")
    sess.execute(cases)
    ex = sess.explain(cases)
    assert ex["precision"] == "int8"
    r = ex["rescue"]
    assert r["scanned"] > 0 and 0 < r["rescued"] <= r["scanned"]
    assert r["ratio"] == pytest.approx(r["rescued"] / r["scanned"])
    ex32 = pt.session(precision="fp32").explain(cases)
    assert ex32["precision"] == "fp32" and ex32["rescue"]["scanned"] == 0


def test_sessions_engines_and_plans_keyed_by_precision(pair):
    _, pt = pair
    s8, s32 = pt.session(precision="int8"), pt.session(precision="fp32")
    assert s8 is not s32 and s8.precision == "int8"
    assert s8.engine() is not s32.engine()
    assert s8.engine().precision == "int8" and s8.engine().plane_bytes() > 0
    cases = _cases(TQ, pt.table)[:2]
    plan = s8.plan(cases)
    assert s8.plan(cases).cache_hit and not s32.plan(cases).cache_hit
    # a plan keyed for one precision refuses an engine of another
    eng_plan = EnginePlan(device_loop=plan.logical.device_loop,
                          job_specs=plan.logical.job_specs,
                          groups=plan.logical.groups, precision="int8")
    with pytest.raises(ValueError, match="precision"):
        s32.engine().execute_batch(cases, plan=eng_plan)


def test_env_override_and_explicit_wins(pair, monkeypatch):
    _, pt = pair
    cases = _cases(TQ, pt.table)[:2]
    monkeypatch.setenv("MQRLD_PRECISION", "int8")
    assert pt.session().precision == "int8"
    _, st = pt.session().execute(cases)
    assert st.mp_scanned > 0
    _, st32 = pt.session(precision="fp32").execute(cases)
    assert st32.mp_scanned == 0
    monkeypatch.setenv("MQRLD_PRECISION", "float64")
    with pytest.raises(ValueError):
        pt.session()
    monkeypatch.delenv("MQRLD_PRECISION")
    pt.default_precision = "bf16"
    try:
        assert pt.session().precision == "bf16"
        assert pt.engine().precision == "bf16"
    finally:
        pt.default_precision = "fp32"
