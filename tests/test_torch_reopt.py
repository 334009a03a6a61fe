"""Online re-optimization in the port on the CPU: index generations
(``build_generation``, ``build_fold_generation``, ``swap``, the in-memory
``rollback``), ``QBSTable.snapshot``, ``ReoptController`` and the
server's ``attach_reopt``.

* The reference's ``tests/test_reopt.py`` on the port's platform and
  server (stub embedder, fake clock): swaps under load stay oracle-exact,
  the swap prewarms the serving plan cache, rollback from memory and from
  disk, the background fold equals the inline one, the delta prefix a
  fold pins, stale generations refused, a torn save, retention,
  ``stats()["reopt"]`` and the append / serve / re-optimize fuzz. Its
  three adaptive-window tests have their counterparts in
  ``tests/test_torch_retrieval.py``; its GP and driver tests are in
  ``tests/test_torch_morbo.py``. Where the reference skips when the
  tuner finds no improvement, ``_evaluate`` is replaced by a fixed
  objective under which every candidate beats the baseline.
* Parity with the reference on carried state (``state_from_numpy``):
  the fold generation, the tail a swap carries, the rolled-back view,
  ``build_generation`` and ``objectives_for_morbo`` without LPGF, the
  workload snapshot, and both controllers under one fixed objective and
  one fake clock.

Results are compared by logical row identity (``view().row_ids``),
captured at the epoch the micro-batch executed: a new generation
re-permutes physical rows. Tolerance: rows exact; the fold generation's
tree, permutation and features exact; the perturbed transform
rtol=atol=1e-5, as in ``tests/test_torch_build.py``; a full rebuild's
tree, permutation and CBR exact where no DPC choice moves between the
packages, and by logical rows with the cause shown where one does
(``test_build_generation_dpc_cutoff_split``).
"""
import os

import numpy as np
import pytest
import torch

from repro.core import persist as jpersist
from repro.core import query as JQ
from repro.core import reopt as jreopt
from repro.core.lake import MMOTable as JTable
from repro.core.platform import MQRLD as JMQRLD
from repro_torch.core import persist
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MAX_ENGINES, MQRLD, state_from_numpy
from repro_torch.core.qbs import QBSTable
from repro_torch.core.reopt import ReoptConfig, ReoptController
from repro_torch.serve.engine import RetrievalRequest, RetrievalServer
from test_torch_engine import ref_state_arrays

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


# ---------------------------------------------------------------------------
# fixtures / helpers
# ---------------------------------------------------------------------------
def _table(M, seed=0, n=650, d=8):
    rng = np.random.default_rng(seed + 17)
    centers = rng.normal(size=(5, d)).astype(np.float32) * 6
    lab = rng.integers(0, 5, n)
    vec = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return (M("reopt_shop").add_vector("img", vec)
            .add_numeric("price", rng.uniform(0, 100, n).astype(np.float32)))


def _make_platform(seed=0, n=650, d=8):
    p = MQRLD(_table(MMOTable, seed, n, d), seed=0, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    return p


def _extra_rows(rng, k, d=8):
    return ({"price": rng.uniform(0, 100, k).astype(np.float32)},
            {"img": rng.normal(size=(k, d)).astype(np.float32) * 4})


def _append(p, rng, k, fold=False):
    num, vec = _extra_rows(rng, k)
    return p.append(numeric=num, vector=vec, fold=fold)


def _fast_cfg(**over):
    """One init batch and one ask/tell pair over a tiny shadow."""
    kw = dict(interval_s=0.0, min_queries=4, sample_rows=256,
              max_workload=6, n_params=2, n_init=3, tune_cycles=1,
              evals_per_step=2, prewarm_sizes=(1, 2), seed=0)
    kw.update(over)
    return ReoptConfig(**kw)


def _fixed_objective(self, theta, dscale):
    """A deterministic stand-in for ``ReoptController._evaluate``: the
    shadow is still re-prepared (the silhouette scores read it), and
    every candidate away from the serving transform beats the baseline
    in time and CBR, so a cycle always ends in a winner."""
    self._shadow.prepare(
        theta=None if theta is None else list(theta),
        delta_scales=None if dscale is None else list(dscale),
        **self.platform._prepare_cfg)
    x = np.concatenate([np.zeros(2) if theta is None else theta,
                        np.zeros(2) if dscale is None else dscale])
    a = float(np.abs(np.asarray(x, np.float64)).sum())
    return np.array([1.0 - 0.1 * a, 0.5 - 0.05 * a, -1.0])


class _StubEmbedder:
    """Deterministic per prompt, independent of batch composition."""

    def __init__(self, table):
        self.table = table

    def embed(self, tokens):
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


def _logical(ids, rows):
    return {int(ids[r]) for r in np.asarray(rows)}


def _logical_view(platform):
    return _logical(platform.view().row_ids,
                    np.arange(platform.view().n_rows))


def _check_exact(platform, result, exec_ids):
    """One served result against the oracle by logical row identity:
    ``exec_ids`` is the view's row_ids at the epoch the micro-batch ran,
    the oracle maps through the current ones."""
    got = _logical(exec_ids, result.rows)
    truth = _logical(platform.view().row_ids,
                     platform.oracle(result.query))
    assert got == truth


def _drain(pending, platform, exec_ids):
    """Check the futures resolved since the last action; return the
    rest."""
    still = []
    for f in pending:
        if f.done():
            res = f.result()
            if not res.shed:
                _check_exact(platform, res, exec_ids)
        else:
            still.append(f)
    return still


# ---------------------------------------------------------------------------
# swap under load
# ---------------------------------------------------------------------------
def test_swap_under_load_stays_oracle_exact():
    """Serve while the attached controller tunes, builds beside, warms
    and swaps: every result before, during and after the swap is the
    oracle's by logical row identity, and the swap lands only between
    micro-batches."""
    p = _make_platform()
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=clk)
    ctl = ReoptController(p, config=_fast_cfg())
    srv.attach_reopt(ctl)
    assert ctl.session is srv.session     # prewarm lands in serving cache

    gen0 = p.generation
    pending = []
    for i in range(60):
        pending.append(srv.submit(_req(i, k=5)))
        pending.append(srv.submit(
            _req(100 + i, k=4, predicate=Q.NR("price", 10, 90))))
        pending = _drain(pending, p, p.view().row_ids.copy())
        exec_ids = p.view().row_ids.copy()   # batch-epoch mapping
        clk.advance(0.002)
        srv.poll()                           # micro-batch + one step()
        pending = _drain(pending, p, exec_ids)
        if ctl.n_swaps >= 1 and not pending:
            break
    exec_ids = p.view().row_ids.copy()
    state = ctl.state
    srv.flush()                              # flush never steps reopt
    assert ctl.state == state
    _drain(pending, p, exec_ids)

    assert ctl.n_swaps >= 1, "controller never swapped under load"
    assert p.generation > gen0
    assert any(e.kind == "swap" for e in ctl.history)
    assert ctl.warm_errors == []
    st = srv.stats()
    assert st["generation"] == p.generation
    assert st["reopt"]["swaps"] == ctl.n_swaps
    assert st["served"] >= 40 and st["shed"] == 0
    f = srv.submit(_req(7, k=6))
    srv.flush()
    _check_exact(p, f.result(), p.view().row_ids)


def test_swap_prewarms_serving_plan_cache(monkeypatch):
    """The controller's generation is warmed against the serving session
    under the build id it will serve under: the first plan after the
    swap for a hot signature is a cache hit, and its engine was built
    before the swap (no engine is built by the first batch)."""
    monkeypatch.setattr(ReoptController, "_evaluate", _fixed_objective)
    p = _make_platform(seed=3)
    sess = p.session()
    ctl = ReoptController(p, session=sess, config=_fast_cfg())
    emb = p.table.vector["img"][:8] + 0.01
    for i in range(8):
        p.execute(Q.VK.of("img", emb[i], 5))   # records workload + mix
    kinds = []
    while not kinds or kinds[-1] != "swapped":
        kinds.append(ctl.step())
        assert len(kinds) < 20, kinds
    assert kinds[-3:] == ["built", "warmed", "swapped"]
    assert "no-improvement" not in kinds
    warm = dict(p._engines)
    assert list(warm) == [p._engine_key(sess.beam, sess.tile,
                                        sess.precision)]
    hits0 = sess.cache_hits
    q = Q.VK.of("img", emb[0], 5)
    (rows,), _ = sess.plan([q]).execute()
    assert sess.cache_hits == hits0 + 1      # warm, not re-planned
    assert p._engines[next(iter(warm))] is next(iter(warm.values()))
    assert _logical(p.view().row_ids, rows) == \
        _logical(p.view().row_ids, p.oracle(q))


# ---------------------------------------------------------------------------
# rollback (memory + disk)
# ---------------------------------------------------------------------------
def test_rollback_roundtrip_memory():
    p = _make_platform(seed=1)
    rng = np.random.default_rng(5)
    q = Q.And.of(Q.NR("price", 15, 85),
                 Q.VK.of("img", p.table.vector["img"][3] + 0.02, 6))
    _append(p, rng, 3, fold=False)
    before = _logical_view(p)
    bid0, gen0 = p.build_id, p.generation

    gen = p.build_generation(theta=[0.08, -0.05],
                             delta_scales=[0.12, -0.07])
    p.swap(gen)
    assert p.build_id == bid0 + 1 and p.generation == gen0 + 1
    assert _logical_view(p) == before        # logical content invariant
    rows, _ = p.execute(q, record=False)
    assert _logical(p.view().row_ids, rows) == \
        _logical(p.view().row_ids, p.oracle(q))

    _append(p, rng, 2, fold=False)           # post-swap writes
    after_appends = _logical_view(p)
    p.rollback()
    assert p.generation == gen0 + 2          # rollback is itself a bump
    assert _logical_view(p) == after_appends
    rows, _ = p.execute(q, record=False)
    assert _logical(p.view().row_ids, rows) == \
        _logical(p.view().row_ids, p.oracle(q))
    assert p._prev_gen is None


def test_rollback_from_disk(tmp_path):
    """A freshly loaded platform (no in-memory previous generation) rolls
    back from the snapshot directory."""
    d = str(tmp_path / "snap")
    p = _make_platform(seed=2)
    persist.save_platform(p, d)
    pre_swap = _logical_view(p)
    g_pre = persist.current_generation(d)

    p.swap(p.build_generation(theta=[0.06, -0.04],
                              delta_scales=[0.05, -0.05]))
    persist.save_platform(p, d)
    assert persist.current_generation(d) > g_pre

    p2 = persist.load_platform(d, device="cpu")
    assert p2._prev_gen is None and p2.snapshot_dir == d
    q = Q.VK.of("img", p2.table.vector["img"][1] + 0.01, 5)
    p2.rollback()                            # disk path
    assert persist.current_generation(d) == g_pre
    assert _logical_view(p2) == pre_swap
    rows, _ = p2.execute(q, record=False)
    assert _logical(p2.view().row_ids, rows) == \
        _logical(p2.view().row_ids, p2.oracle(q))


def test_rollback_without_history_raises():
    p = _make_platform(seed=4)
    with pytest.raises(RuntimeError, match="roll"):
        p.rollback()


def test_disk_rollback_clears_the_memory_generation(tmp_path):
    """``rollback_platform(into=...)`` drops the in-memory previous
    generation, as the reference's does: a later ``rollback()`` cannot
    restore a state older than the disk's."""
    d = str(tmp_path / "snap")
    p = _make_platform(seed=5)
    persist.save_platform(p, d)
    persist.save_platform(p, d)
    p.swap(p.build_generation(theta=[0.02, 0.01]))
    assert p._prev_gen is not None
    persist.rollback_platform(d, into=p)
    assert p._prev_gen is None


def test_fold_and_prepare_drop_the_memory_generation():
    """A fold or a prepare after a swap merges rows the displaced state
    never held, so the port drops ``_prev_gen`` there (the reference
    keeps it, and its rollback would lose those rows): ``rollback()``
    then raises instead of losing writes."""
    rng = np.random.default_rng(8)
    for rebuild in ("fold", "prepare"):
        p = _make_platform(seed=6)
        p.swap(p.build_generation(theta=[0.03, -0.02]))
        _append(p, rng, 3, fold=False)
        if rebuild == "fold":
            p.fold()
        else:
            p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
        assert p._prev_gen is None
        with pytest.raises(RuntimeError, match="roll"):
            p.rollback()
        assert p.n_base == 653


# ---------------------------------------------------------------------------
# background fold == inline fold
# ---------------------------------------------------------------------------
def test_background_fold_matches_inline():
    """The controller's fold generation is bit-identical to the inline
    ``fold()`` on the same state."""
    rng1 = np.random.default_rng(9)
    rng2 = np.random.default_rng(9)
    p1 = _make_platform(seed=6)
    p2 = _make_platform(seed=6)

    _append(p1, rng1, 12, fold=True)         # inline

    p2.fold_mode = "background"
    p2.auto_fold_ratio = 1e-9
    _append(p2, rng2, 12, fold=None)         # marks only
    assert p2.fold_due and p2.delta.m == 12
    ctl = ReoptController(p2, config=_fast_cfg(interval_s=1e9))
    assert ctl.step() == "fold-built"
    assert ctl.status()["state"] == "fold-pending"
    assert ctl.step() == "fold-swapped"
    assert ctl.n_folds == 1 and p2.n_delta == 0 and not p2.fold_due

    np.testing.assert_array_equal(p1.table.row_ids, p2.table.row_ids)
    np.testing.assert_array_equal(p1.enhanced, p2.enhanced)
    np.testing.assert_array_equal(p1.tree.bucket_start,
                                  p2.tree.bucket_start)
    q = Q.VK.of("img", p1.table.vector["img"][2] + 0.01, 7)
    r1, _ = p1.execute(q, record=False)
    r2, _ = p2.execute(q, record=False)
    assert _logical(p1.view().row_ids, r1) == \
        _logical(p2.view().row_ids, r2)


def test_fold_generation_pins_delta_prefix():
    """Rows appended after a beside-build started stay in the delta
    across the swap, served from the new generation's delta tail."""
    p = _make_platform(seed=7)
    rng = np.random.default_rng(11)
    p.fold_mode = "background"
    p.auto_fold_ratio = 1e-9
    _append(p, rng, 6, fold=None)
    gen = p.build_fold_generation()          # consumes the 6-row prefix
    _append(p, rng, 2, fold=False)           # lands mid-build
    before = _logical_view(p)
    p.swap(gen)
    assert p.delta.m == 2                    # tail carried, not folded
    assert _logical_view(p) == before
    q = Q.VK.of("img", p.table.vector["img"][0] + 0.01, 5)
    rows, _ = p.execute(q, record=False)
    assert _logical(p.view().row_ids, rows) == \
        _logical(p.view().row_ids, p.oracle(q))
    (brows,), _ = p.session().plan([q]).execute()
    assert _logical(p.view().row_ids, brows) == \
        _logical(p.view().row_ids, p.oracle(q))


def test_stale_generation_rejected():
    """A generation built against an older build id is refused by
    ``swap`` and discarded, not installed, by the controller."""
    p = _make_platform(seed=8)
    gen = p.build_generation(theta=[0.03, 0.02],
                             delta_scales=[0.0, 0.0])
    _append(p, np.random.default_rng(1), 4, fold=True)
    with pytest.raises(RuntimeError, match="stale"):
        p.swap(gen)
    ctl = ReoptController(p, config=_fast_cfg())
    ctl._gen = p.build_generation(theta=[0.01, 0.0])
    ctl._winner = ([0.01, 0.0], [0.0, 0.0], np.zeros(3))
    ctl.state = "warmed"
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    build = p.build_id
    assert ctl.step() == "stale-discarded"
    assert ctl.state == "idle" and p.build_id == build


def test_swap_keeps_at_most_max_engines_and_the_cost_model():
    p = _make_platform(seed=9)
    p.cost_model = model = object()
    gen = p.build_generation(theta=[0.02, -0.01])
    gen.engines = {("k", i): i for i in range(MAX_ENGINES + 2)}
    p.swap(gen)
    assert list(p._engines.values()) == list(range(2, MAX_ENGINES + 2))
    assert p.cost_model is model


# ---------------------------------------------------------------------------
# persistence around swaps
# ---------------------------------------------------------------------------
def test_crash_mid_save_recovery(tmp_path, monkeypatch):
    d = str(tmp_path / "snap")
    p = _make_platform(seed=9)
    persist.save_platform(p, d)
    g0 = persist.current_generation(d)
    ref = _logical_view(p)

    real = persist._write_snapshot

    def _boom(platform, directory):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "platform.json"), "w") as f:
            f.write('{"partial": tru')         # torn write, then crash
        raise RuntimeError("disk full")

    monkeypatch.setattr(persist, "_write_snapshot", _boom)
    _append(p, np.random.default_rng(2), 2, fold=False)
    with pytest.raises(RuntimeError, match="disk full"):
        persist.save_platform(p, d)
    monkeypatch.setattr(persist, "_write_snapshot", real)

    assert persist.current_generation(d) == g0
    assert not [e for e in os.listdir(d) if e.startswith(".tmp-")]
    p2 = persist.load_platform(d, device="cpu")
    assert _logical_view(p2) == ref

    persist.save_platform(p, d)
    assert persist.current_generation(d) > g0
    p3 = persist.load_platform(d, device="cpu")
    assert _logical_view(p3) == _logical_view(p)


def test_retention_keeps_rollback_window(tmp_path):
    d = str(tmp_path / "snap")
    p = _make_platform(seed=10)
    for _ in range(4):
        persist.save_platform(p, d)
        p.swap(p.build_generation(theta=[0.01, -0.01],
                                  delta_scales=[0.0, 0.0]))
    gens = persist.list_generations(d)
    assert len(gens) == persist._KEEP_GENERATIONS
    assert persist.current_generation(d) == gens[-1]
    persist.load_platform(d, generation=gens[0], device="cpu")


# ---------------------------------------------------------------------------
# the server's hooks
# ---------------------------------------------------------------------------
def test_stats_reports_generation_and_reopt():
    p = _make_platform(seed=15)
    srv = RetrievalServer(p, _StubEmbedder(p.table))
    st = srv.stats()
    assert st["generation"] == p.generation
    assert st["build_id"] == p.build_id
    assert st["reopt"] is None
    ctl = ReoptController(p, config=_fast_cfg(min_queries=10 ** 9))
    srv.attach_reopt(ctl)
    st = srv.stats()
    assert st["reopt"]["state"] == "idle"
    assert st["reopt"]["generation"] == p.generation
    assert st["reopt"]["warm_errors"] == 0
    assert srv.poll() == 0                   # idle poll steps the (idle)
    assert srv.stats()["reopt"]["swaps"] == 0   # controller harmlessly


def test_attach_keeps_a_controllers_own_session():
    p = _make_platform(seed=15)
    own = p.session(precision="bf16")
    srv = RetrievalServer(p, _StubEmbedder(p.table))
    ctl = ReoptController(p, session=own, config=_fast_cfg())
    srv.attach_reopt(ctl)
    assert srv.reopt is ctl and ctl.session is own


class _StepLog:
    """A controller stand-in that records the server's state at each
    step."""

    def __init__(self, srv):
        self.srv = srv
        self.session = srv.session
        self.seen = []

    def step(self):
        self.seen.append(self.srv.inflight_chunks)
        return "idle"

    def status(self):
        return {}


@pytest.mark.parametrize("depth", [1, 2])
def test_poll_steps_between_micro_batches_only(depth):
    """Serial mode steps after each micro-batch and at idle points;
    pipelined mode steps only with the pipe empty and never on a tick a
    shape prewarm used; ``flush()`` never steps."""
    p = _make_platform(seed=17)
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          pipeline_depth=depth, clock=clk)
    log = _StepLog(srv)
    srv.attach_reopt(log)
    assert srv.poll() == 0 and len(log.seen) == 1   # idle point
    for i in range(12):
        srv.submit(_req(i, k=5))
    n = len(log.seen)
    srv.flush()
    assert len(log.seen) == n                # flush never steps
    for i in range(20):
        srv.submit(_req(i, k=5 + i % 2))
        clk.advance(0.001)
        srv.poll()
    for _ in range(10):
        srv.poll()
    assert log.seen and set(log.seen) == {0}
    if depth > 1:                            # prewarm ticks took no step
        assert not srv._pipe._warm_queue


def test_warm_up_failure_is_kept_not_raised(monkeypatch):
    """A warm-up whose engine build raises does not block the swap: the
    error's text is kept in ``warm_errors``, the generation swaps with no
    engine, and the next ``engine()`` builds one."""
    monkeypatch.setattr(ReoptController, "_evaluate", _fixed_objective)
    p = _make_platform(seed=18)
    ctl = ReoptController(p, session=p.session(), config=_fast_cfg())
    for i in range(6):
        p.execute(Q.VK.of("img", p.table.vector["img"][i] + 0.01, 5))
    from repro_torch.core import engine as eng_mod

    class _Boom(eng_mod.HybridEngine):
        def execute_batch(self, *a, **kw):
            raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(eng_mod, "HybridEngine", _Boom)
    kinds = []
    while not kinds or kinds[-1] != "swapped":
        kinds.append(ctl.step())
        assert len(kinds) < 20, kinds
    monkeypatch.undo()
    assert ctl.warm_errors == ["RuntimeError: CUDA error: launch failed"]
    assert ctl.status()["warm_errors"] == 1
    assert p._engines == {}
    q = Q.VK.of("img", p.table.vector["img"][4] + 0.01, 5)
    (rows,), _ = p.session().plan([q]).execute()
    assert len(p._engines) == 1
    np.testing.assert_array_equal(rows, p.oracle(q))


# ---------------------------------------------------------------------------
# seeded fuzz: append / serve / re-optimize interleaved
# ---------------------------------------------------------------------------
def test_fuzz_append_serve_reopt_interleaving():
    """Submits, polls (each stepping the controller: tuning,
    beside-builds, swaps, background folds) and appends, interleaved:
    every future resolves once, every served result is the oracle's by
    logical identity at its epoch, and the counters reconcile."""
    rng = np.random.default_rng(42)
    p = _make_platform(seed=16, n=500)
    p.fold_mode = "background"
    p.auto_fold_ratio = 0.02                 # folds fire under the fuzz
    clk = _FakeClock()
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          max_delay_ms=1.0, clock=clk)
    ctl = ReoptController(p, config=_fast_cfg(min_queries=8))
    srv.attach_reopt(ctl)

    pending, n_sub = [], 0
    for i in range(80):
        r = rng.random()
        if r < 0.55:
            kind = int(rng.integers(3))
            req = (_req(i, k=5) if kind == 0 else
                   _req(i, k=8) if kind == 1 else
                   _req(i, k=4, predicate=Q.NR("price", 20, 80)))
            ids = p.view().row_ids.copy()    # submit may auto-flush
            pending.append(srv.submit(req))
            n_sub += 1
            pending = _drain(pending, p, ids)
        elif r < 0.85:
            ids = p.view().row_ids.copy()
            clk.advance(float(rng.uniform(0, 0.003)))
            srv.poll()
            pending = _drain(pending, p, ids)
        else:
            srv.append(numeric=_extra_rows(rng, 2)[0],
                       vectors=_extra_rows(rng, 2)[1])
    clk.advance(10.0)
    ids = p.view().row_ids.copy()
    srv.flush()
    pending = _drain(pending, p, ids)

    assert not pending
    st = srv.stats()
    assert st["submitted"] == n_sub
    assert st["served"] + st["shed"] == n_sub and st["shed"] == 0
    assert ctl.n_folds + ctl.n_swaps >= 1
    assert st["generation"] == p.generation
    q = Q.VK.of("img", p.table.vector["img"][5] + 0.01, 6)
    rows, _ = p.execute(q, record=False)
    assert _logical(p.view().row_ids, rows) == \
        _logical(p.view().row_ids, p.oracle(q))


def test_exact_ties_across_a_fold_are_held_to_the_batchs_own_view():
    """Rows at exactly equal distances (every vector four times in the
    base, 60 more copies appended into the delta) order by physical row,
    in the engine and in the oracle alike, and a fold re-permutes the
    rows: served V.K results, in order, equal the oracle over the view
    each batch ran on, before and after the fold; the oracle over the
    folded view orders the same queries' tied rows otherwise, so a truth
    taken at another epoch than the batch's reports false mismatches."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(5, 8)).astype(np.float32) * 6
    base = (centers[rng.integers(0, 5, 150)]
            + rng.normal(size=(150, 8))).astype(np.float32)
    vec = np.repeat(base, 4, axis=0)[rng.permutation(600)]
    p = MQRLD(MMOTable("ties").add_vector("img", vec).add_numeric(
        "price", rng.uniform(0, 100, 600).astype(np.float32)), seed=0,
        device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    srv = RetrievalServer(p, _StubEmbedder(p.table), batch_size=4,
                          clock=_FakeClock())
    dup = p.table.vector["img"][rng.choice(600, 60, replace=False)]
    srv.append(numeric={"price": rng.uniform(0, 100, 60).astype(
        np.float32)}, vectors={"img": dup})

    def serve(ids):
        view = p.view()
        futs = [srv.submit(_req(i, k=6)) for i in ids]
        srv.flush()
        return [(f.result(), view) for f in futs]

    def ordered(view, rows):
        return [int(view.row_ids[r]) for r in rows]

    before = serve(range(40))
    gen = p.generation
    p.fold()
    assert p.n_delta == 0 and p.generation != gen
    after = serve(range(40))
    folded = p.view()
    stale = 0
    for res, view in before + after:
        truth = Q.execute_bruteforce(view, res.query)
        assert ordered(view, res.rows) == ordered(view, truth)
        stale += ordered(view, res.rows) != ordered(
            folded, Q.execute_bruteforce(folded, res.query))
    assert stale > 0        # only pre-fold batches, through their ties
    assert all(ordered(v, r.rows) == ordered(folded, Q.execute_bruteforce(
        folded, r.query)) for r, v in after)


# ---------------------------------------------------------------------------
# parity with the reference on carried state
# ---------------------------------------------------------------------------
def _carry(seed=0):
    jp = JMQRLD(_table(JTable, seed), seed=0)
    jp.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    pt = state_from_numpy(ref_state_arrays(jp), device="cpu")
    pt._prepare_cfg = dict(jp._prepare_cfg)
    return jp, pt


def _both_append(jp, pt, rng, k):
    num, vec = _extra_rows(rng, k)
    for plat in (jp, pt):
        plat.append(numeric=num, vector=vec, fold=False)


def _assert_same_state(t, j):
    """Table, tree, permutation and enhanced features array for array."""
    np.testing.assert_array_equal(t.table.row_ids, j.table.row_ids)
    np.testing.assert_array_equal(t.table.bucket_starts,
                                  j.table.bucket_starts)
    for k in j.table.vector:
        np.testing.assert_array_equal(t.table.vector[k], j.table.vector[k])
    for k in j.table.numeric:
        np.testing.assert_array_equal(t.table.numeric[k],
                                      j.table.numeric[k])
    for k in ("bucket_start", "bucket_end", "radius", "lm_a", "lm_b",
              "centroid", "parent", "is_leaf", "depth"):
        np.testing.assert_array_equal(getattr(t.tree, k),
                                      getattr(j.tree, k), err_msg=k)
    assert t.tree.children == j.tree.children
    np.testing.assert_array_equal(t.enhanced, j.enhanced)


@pytest.fixture(scope="module")
def generations():
    """Both packages on one carried state through the same appends, a
    fold generation, a swap carrying a 3-row tail, post-swap appends and
    the in-memory rollback."""
    jp, pt = _carry(seed=20)
    rng = np.random.default_rng(31)
    _both_append(jp, pt, rng, 9)
    gens = (jp.build_fold_generation(), pt.build_fold_generation())
    rec = {"gens": gens}
    _both_append(jp, pt, rng, 3)
    rec["swap"] = (jp.swap(gens[0]), pt.swap(gens[1]))
    rec["after_swap"] = [(p.view(), p.delta.m) for p in (jp, pt)]
    _both_append(jp, pt, rng, 2)
    rec["rollback"] = (jp.rollback(), pt.rollback())
    rec["after_rollback"] = [(p.view(), p.delta.m) for p in (jp, pt)]
    rec["platforms"] = (jp, pt)
    return rec


def _same_view(tv, jv):
    np.testing.assert_array_equal(tv.row_ids, jv.row_ids)
    for k in jv.vector:
        np.testing.assert_array_equal(tv.vector[k], jv.vector[k])
    for k in jv.numeric:
        np.testing.assert_array_equal(tv.numeric[k], jv.numeric[k])


def test_fold_generation_matches_reference(generations):
    jg, tg = generations["gens"]
    assert (tg.kind, tg.delta_consumed, tg.gen_id) == \
        (jg.kind, jg.delta_consumed, jg.gen_id) == ("fold", 9, 2)
    _assert_same_state(tg, jg)
    np.testing.assert_array_equal(tg.raw_table.vector["img"],
                                  jg.raw_table.vector["img"])
    for f in ("vec_centroid", "vec_radius", "num_lo", "num_hi"):
        for k, v in getattr(jg.meta, f).items():
            np.testing.assert_array_equal(getattr(tg.meta, f)[k], v)


def test_swap_carries_the_reference_tail(generations):
    assert generations["swap"][0] == generations["swap"][1]
    (jv, jm), (tv, tm) = generations["after_swap"]
    assert tm == jm == 3
    _same_view(tv, jv)


def test_memory_rollback_matches_reference(generations):
    assert generations["rollback"][0] == generations["rollback"][1]
    (jv, jm), (tv, tm) = generations["after_rollback"]
    assert tm == jm == 14
    _same_view(tv, jv)
    jp, pt = generations["platforms"]
    _assert_same_state(pt, jp)
    assert pt._prev_gen is None and jp._prev_gen is None


# (theta, delta_scales) of the parity rebuild: on seed 21's carried state
# no DPC choice of either build moves between the packages at _AGREE, and
# one does at _SPLIT (test_build_generation_dpc_cutoff_split says why)
_AGREE = ([0.02, 0.01], [0.05, 0.0])
_SPLIT = ([0.07, -0.04], [0.1, -0.05])


def _rebuild_pair(theta, dscale):
    jp, pt = _carry(seed=21)
    for p in (jp, pt):
        p._prepare_cfg["use_lpgf"] = False
    _both_append(jp, pt, np.random.default_rng(4), 5)
    gens = (jp.build_generation(theta=theta, delta_scales=dscale),
            pt.build_generation(theta=theta, delta_scales=dscale))
    return gens, (jp, pt)


@pytest.fixture(scope="module")
def rebuilt():
    """``build_generation`` and ``objectives_for_morbo`` without LPGF on
    both packages' carried state (with a live delta), at ``_AGREE``."""
    gens, (jp, pt) = _rebuild_pair(*_AGREE)
    e = jp.table.vector["img"][:6] + 0.01
    work = ([JQ.VK.of("img", v, 5) for v in e],
            [Q.VK.of("img", v, 5) for v in e])
    x = np.asarray(_AGREE[0] + _AGREE[1])
    objs = (jp.objectives_for_morbo(work[0])(x),
            pt.objectives_for_morbo(work[1])(x))
    return gens, objs, (jp, pt)


def _assert_same_tree(t, j):
    assert t.children == j.children
    for f in ("parent", "is_leaf", "bucket_start", "bucket_end", "depth"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    for f in ("centroid", "radius", "lm_a", "lm_b"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_build_generation_matches_reference(rebuilt):
    """The perturbed transform and the enhanced features within
    tolerance; the tree, the permutation and the re-laid table exact."""
    (jg, tg), _, _ = rebuilt
    assert (tg.kind, tg.delta_consumed) == (jg.kind, jg.delta_consumed) \
        == ("reopt", 5)
    for k in ("r", "s", "mean"):
        np.testing.assert_allclose(getattr(tg.transform, k),
                                   getattr(jg.transform, k),
                                   rtol=RTOL, atol=ATOL)
    for t, j in zip(tg.params, jg.params):
        np.testing.assert_array_equal(t, j)
    assert tg.table.n_rows == jg.table.n_rows == 655
    assert tg.report.n_leaves == jg.report.n_leaves > 1
    _assert_same_tree(tg.tree, jg.tree)
    np.testing.assert_array_equal(tg.table.row_ids, jg.table.row_ids)
    np.testing.assert_array_equal(tg.table.bucket_starts,
                                  jg.table.bucket_starts)
    np.testing.assert_array_equal(tg.table.vector["img"],
                                  jg.table.vector["img"])
    np.testing.assert_array_equal(tg.table.numeric["price"],
                                  jg.table.numeric["price"])
    np.testing.assert_allclose(tg.enhanced, jg.enhanced,
                               rtol=RTOL, atol=ATOL)


def test_build_generation_dpc_cutoff_split():
    """Where the trees part, and why. At ``_SPLIT`` the two generations
    hold the same logical rows with the same content but split one
    subtree differently. The transform is not the cause: the port's
    ``build_index`` on the reference's own features splits the same way
    as the port's generation. At the first node where the trees part,
    both hold the same rows, and DPC's default cutoff ``dc`` (the 2%
    quantile of the sampled distances above 1e-12) differs: on these
    features (|x|^2 ~ 1e6) the fp32 expansion leaves self-distances of up
    to ~0.5, and XLA's and torch's summation orders leave a different
    number of them above 1e-12. Given one cutoff, both DPCs label the
    node alike."""
    from repro.core.dpc import dpc as jdpc
    from repro.core.index import build_index as jbuild_index
    from repro.kernels import ops as jops
    from repro_torch.core.dpc import dpc as tdpc
    from repro_torch.core.index import build_index as tbuild_index
    from repro_torch.kernels import ops as tops
    (jg, tg), (jp, _) = _rebuild_pair(*_SPLIT)
    assert sorted(tg.table.row_ids) == sorted(jg.table.row_ids) \
        == list(range(655))
    to, jo = np.argsort(tg.table.row_ids), np.argsort(jg.table.row_ids)
    np.testing.assert_array_equal(tg.table.vector["img"][to],
                                  jg.table.vector["img"][jo])
    np.testing.assert_allclose(tg.enhanced[to], jg.enhanced[jo],
                               rtol=RTOL, atol=ATOL)
    assert tg.tree.children != jg.tree.children

    cfg = jp._prepare_cfg
    kw = dict(delta=cfg["delta"], min_leaf=cfg["min_leaf"],
              max_leaf=cfg["max_leaf"], max_depth=cfg["max_depth"],
              dpc_max_clusters=cfg["dpc_max_clusters"],
              dpc_sample=cfg["dpc_sample"], seed=0)
    feats = np.empty_like(jg.enhanced)
    feats[jg.table.row_ids] = jg.enhanced        # the reference's, raw order
    jt, jperm, _ = jbuild_index(feats, **kw)
    tt, tperm, _ = tbuild_index(feats, device="cpu", **kw)
    np.testing.assert_array_equal(jperm, jg.table.row_ids)
    np.testing.assert_array_equal(tperm, tg.table.row_ids)

    def rows_under(tree, perm, u):
        out, st = [], [u]
        while st:
            v = st.pop()
            if tree.is_leaf[v]:
                out.append(perm[tree.bucket_start[v]:tree.bucket_end[v]])
            else:
                st.extend(tree.children[v])
        return np.sort(np.concatenate(out))

    def kids(tree, perm, u):
        return sorted(int(rows_under(tree, perm, c)[0])
                      for c in tree.children[u])

    u = next(u for u in range(min(jt.n_nodes, tt.n_nodes))
             if kids(jt, jperm, u) != kids(tt, tperm, u))
    rows = rows_under(jt, jperm, u)
    np.testing.assert_array_equal(rows, rows_under(tt, tperm, u))
    sub = feats[rows]
    n, mc = len(sub), cfg["dpc_max_clusters"]
    samp = sub[np.random.default_rng(0).choice(n, min(1024, n),
                                               replace=False)]
    jd = np.asarray(jops.pairwise_sq_l2(samp, samp))
    td = tops.pairwise_sq_l2(torch.as_tensor(samp),
                             torch.as_tensor(samp)).numpy()
    assert (np.diag(jd) > 1e-12).sum() != (np.diag(td) > 1e-12).sum()
    dcs = [float(np.quantile(np.sqrt(d[d > 1e-12]), 0.02)) for d in (jd, td)]
    assert dcs[0] != dcs[1]
    assert not np.array_equal(jdpc(sub, max_clusters=mc, seed=0).labels,
                              tdpc(sub, max_clusters=mc, seed=0,
                                   device="cpu").labels)
    for dc in dcs:
        np.testing.assert_array_equal(
            jdpc(sub, dc=dc, max_clusters=mc, seed=0).labels,
            tdpc(sub, dc=dc, max_clusters=mc, seed=0, device="cpu").labels)


def test_swapped_generation_serves_oracle_rows(rebuilt):
    (_, tg), _, _ = rebuilt
    p = MQRLD(_table(MMOTable, 21), seed=0, device="cpu")
    p.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5, use_lpgf=False)
    p.append(numeric={"price": tg.raw_table.numeric["price"][650:]},
             vector={"img": tg.raw_table.vector["img"][650:]}, fold=False)
    gen = p.build_generation(theta=_AGREE[0], delta_scales=_AGREE[1])
    np.testing.assert_array_equal(gen.table.row_ids, tg.table.row_ids)
    p.swap(gen)
    e = p.view().vector["img"][::50] + 0.01
    qs = [Q.VK.of("img", v, 7) for v in e] + \
        [Q.And.of(Q.NR("price", 20, 70), Q.VK.of("img", v, 5)) for v in e]
    rows, _ = p.session().plan(qs).execute()
    for q, r in zip(qs, rows):
        assert _logical(p.view().row_ids, r) == \
            _logical(p.view().row_ids, p.oracle(q))


def test_objectives_for_morbo_match_reference(rebuilt):
    """CBR and accuracy identical (wall time is not compared), from the
    same tree: ``objectives_for_morbo`` rebuilds with ``prepare()``'s
    defaults, which are what both platforms then hold."""
    _, (jy, ty), (jp, pt) = rebuilt
    assert ty[2] == jy[2] == -1.0
    assert ty[1] == jy[1] and 0.0 < ty[1] < 1.0
    assert ty[0] > 0.0
    _assert_same_tree(pt.tree, jp.tree)
    np.testing.assert_array_equal(pt.table.row_ids, jp.table.row_ids)
    assert pt._prepare_cfg == jp._prepare_cfg
    assert pt._prepare_cfg["use_lpgf"] is False
    assert pt._prepare_cfg["min_leaf"] == 32      # prepare()'s defaults


def test_snapshot_matches_reference():
    jt, tt = __import__("repro.core.qbs", fromlist=["QBSTable"]).QBSTable(), \
        QBSTable()
    rng = np.random.default_rng(2)
    for i in range(70):
        sig = f"s{int(rng.integers(4))}"
        n = int(rng.integers(1, 4))
        for t in (jt, tt):
            t.record_workload(sig, (sig, i), n=n)
            t.record_latency(sig, 0.001 * (i % 7), n=n)
            t.record_convergence(sig, i % 5)
    for m in (1, 6, 16, 100):
        js, ts = jt.snapshot(max_queries=m), tt.snapshot(max_queries=m)
        assert ts.workload == js.workload
        assert ts.mix == js.mix and ts.latency == js.latency
        assert ts.convergence == js.convergence
        assert ts.n_rows == js.n_rows and ts.total_executed == \
            js.total_executed
    snap = tt.snapshot(max_queries=8)
    snap.mix["s0"] = -1
    snap.convergence["s0"].append(99)
    assert tt.mix["s0"] != -1 and tt.convergence["s0"][-1] != 99


def test_controllers_match_reference(monkeypatch):
    """Both controllers over carried state, under one fixed objective
    and one fake clock, through a cycle, a background fold and a second
    cycle: the same step() results, winners, history kinds and
    generation ids."""
    monkeypatch.setattr(ReoptController, "_evaluate", _fixed_objective)
    monkeypatch.setattr(jreopt.ReoptController, "_evaluate",
                        _fixed_objective)
    jp, pt = _carry(seed=22)
    e = jp.table.vector["img"][:10] + 0.01
    for i, v in enumerate(e):
        jp.execute(JQ.VK.of("img", v, 5 + i % 2))
        pt.execute(Q.VK.of("img", v, 5 + i % 2))
    out = []
    for p, C, Cfg in ((jp, jreopt.ReoptController, jreopt.ReoptConfig),
                      (pt, ReoptController, ReoptConfig)):
        clk = _FakeClock()
        cfg = Cfg(interval_s=5.0, min_queries=4, sample_rows=256,
                  max_workload=6, n_params=2, n_init=3, tune_cycles=1,
                  evals_per_step=2, prewarm_sizes=(1, 2), seed=3)
        ctl = C(p, session=p.session(), config=cfg, clock=clk)
        kinds = []
        for j in range(24):
            if j == 9:
                p.fold_mode = "background"
                p.auto_fold_ratio = 1e-9
                p.append(numeric={"price": np.float32([1.0, 2.0])},
                         vector={"img": e[:2] + 0.5}, fold=None)
            kinds.append(ctl.step())
            clk.advance(1.0)
        st = ctl.status()
        st.pop("warm_errors", None)
        out.append((kinds, [(h.kind, h.gen_id, h.params)
                            for h in ctl.history], st,
                    ctl._rng.integers(2 ** 31)))
    (jk, jh, jst, jr), (tk, th, tst, tr) = out
    assert tk == jk
    assert "swapped" in tk and "fold-swapped" in tk
    assert [h[:2] for h in th] == [h[:2] for h in jh]
    for (_, _, tpar), (_, _, jpar) in zip(th, jh):
        assert jpar is None or tpar == jpar   # the port also keeps a
        #                                      no-improvement's best
    assert tst == jst and tr == jr
    # the same logical rows and content (the tuned rebuild's DPC may
    # assign a few rows differently: test_build_generation_dpc_cutoff_split)
    tv, jv = pt.view(), jp.view()
    to, jo = np.argsort(tv.row_ids), np.argsort(jv.row_ids)
    np.testing.assert_array_equal(tv.row_ids[to], jv.row_ids[jo])
    np.testing.assert_array_equal(tv.vector["img"][to], jv.vector["img"][jo])


def test_loaded_platform_builds_with_prepare_defaults(tmp_path):
    """Neither package's snapshot holds ``_prepare_cfg``: a loaded
    platform's beside-build uses ``prepare()``'s defaults, not the
    serving index's (a reference behaviour the port keeps)."""
    jp, pt = _carry(seed=23)
    pt.prepare(min_leaf=8, max_leaf=64, dpc_max_clusters=5)
    defaults = MQRLD(_table(MMOTable, 23), device="cpu")._prepare_cfg
    assert JMQRLD(_table(JTable, 23))._prepare_cfg == defaults
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jpersist.save_platform(jp, jd)
    persist.save_platform(pt, td)
    loaded = (jpersist.load_platform(jd),
              persist.load_platform(td, device="cpu"),
              persist.load_platform(jd, device="cpu"))
    for lp in loaded:
        assert lp._prepare_cfg == defaults
        assert lp._prepare_cfg != pt._prepare_cfg
    gen = loaded[1].build_generation(theta=[0.02, 0.0])
    assert gen.report.n_leaves < pt.report.n_leaves   # min_leaf 32, not 8
