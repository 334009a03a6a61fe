"""Online query-aware re-optimization (the paper's §5.2.2 Step 4 /
Algorithm 1 loop, run against the live platform). Port of
``repro/core/reopt.py``.

``ReoptController`` watches the live ``QBSTable``, tunes the hyperspace
transform against the measured workload, and installs the winner as a
new index generation between micro-batches:

  1. SNAPSHOT: ``QBSTable.snapshot()`` exports the archetype mix, the
     rings and a hottest-first sample of recently executed query ASTs,
     the workload the tuner optimizes for.
  2. TUNE: a ``MorboDriver`` (ask/tell) proposes (θ, δ) Givens and
     log-scale perturbations of the transform; each is evaluated on a
     SHADOW platform, a small sample of the live view on the same
     device, re-prepared per candidate, by replaying the workload on its
     scalar path (host numpy, as in the reference) and measuring (mean
     time, mean CBR, -mean accuracy) against the shadow's own oracle.
     The serving index is never touched.
  3. BUILD BESIDE: the winner materializes through
     ``MQRLD.build_generation`` without touching serving state.
  4. WARM: hot plan signatures are prewarmed into the serving session's
     plan cache under the build id the generation will serve under
     (``Session.prewarm``), and a ``HybridEngine`` over the incoming
     generation is built on the platform's device and run on sample
     queries, so the first batch after the swap finds its plans and its
     device state ready.
  5. SWAP: ``MQRLD.swap`` installs the generation; the previous one stays
     in memory for ``rollback()``.

The same machinery runs background folds: under ``fold_mode =
"background"`` an ``append()`` only marks ``fold_due``, and the
controller builds the fold generation beside (``build_fold_generation``)
and swaps it in, ahead of any tuning.

Scheduling is cooperative: ``step()`` does one bounded unit of work (one
evaluation slice, one beside-build, one warm-up, one swap) and returns;
``serve.RetrievalServer`` calls it at idle points and between
micro-batches, never while a chunk is in flight, so no request observes
a half-installed state.

A warm-up that fails (a CUDA out-of-memory error, a failed launch) does
not block the swap, as in the reference, but it is not silent either:
its text is kept in ``warm_errors`` and counted in ``status()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.lake import MMOTable
from repro_torch.core.measurement import sc_score
from repro_torch.core.morbo import MorboDriver
from repro_torch.core.platform import MQRLD, Generation
from repro_torch.core.qbs import QBSSnapshot, accuracy


@dataclass
class ReoptConfig:
    """Knobs of the online loop (defaults sized for the test scale; a
    deployment raises ``sample_rows`` and ``interval_s``)."""
    interval_s: float = 30.0      # min seconds between tuning cycles
    min_queries: int = 16         # QBS executions before tuning starts
    sample_rows: int = 1024       # shadow sample size
    max_workload: int = 16        # workload ASTs replayed per candidate
    n_params: int = 4             # (θ, δ) pairs tuned
    theta_range: float = 0.6      # |θ| box bound (radians)
    scale_range: float = 0.3      # |δ| box bound (log-scale units)
    n_init: int = 6               # MORBO space-filling evaluations
    tune_cycles: int = 4          # post-init ask/tell pairs per cycle
    evals_per_step: int = 4       # candidate evaluations per step() call
    min_improvement: float = 0.0  # relative score gain required to swap
    prewarm_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    seed: int = 0


@dataclass
class ReoptEvent:
    """One history entry (a finished cycle, a swap or a fold)."""
    kind: str                     # "swap" | "fold" | "no-improvement" ...
    gen_id: Optional[int] = None
    params: Optional[Dict] = None
    baseline: Optional[List[float]] = None   # (time, cbr, -acc)
    best: Optional[List[float]] = None
    sc_before: Optional[float] = None
    sc_after: Optional[float] = None
    ts: float = 0.0


class ReoptController:
    """The cooperative online tuner over a prepared platform (plus the
    serving session whose plan cache is prewarmed; a server's
    ``attach_reopt`` supplies its own). Call ``step()`` at idle points;
    the module doc gives the state machine. Every shadow, generation and
    engine it makes lives on ``platform.device``."""

    def __init__(self, platform: MQRLD, *, session=None,
                 config: Optional[ReoptConfig] = None,
                 clock=time.monotonic):
        self.platform = platform
        self.session = session
        self.config = config or ReoptConfig()
        self.clock = clock
        self.state = "idle"
        self.history: List[ReoptEvent] = []
        self.n_swaps = 0
        self.n_folds = 0
        self.cycles_run = 0
        # text of every failed warm-up (the swap went ahead cold)
        self.warm_errors: List[str] = []
        self._last_cycle = -float("inf")
        self._rng = np.random.default_rng(self.config.seed)
        # tuning-cycle state
        self._driver: Optional[MorboDriver] = None
        self._snapshot: Optional[QBSSnapshot] = None
        self._shadow: Optional[MQRLD] = None
        self._workload: List = []
        self._baseline_y: Optional[np.ndarray] = None
        self._sc_before: Optional[float] = None
        self._pending_x: Optional[np.ndarray] = None
        self._pending_y: List[np.ndarray] = []
        self._cycles_done = 0
        self._winner: Optional[Tuple] = None     # (theta, dscale, y)
        self._gen: Optional[Generation] = None   # built, not swapped

    # ------------------------------------------------------------ public
    def step(self) -> str:
        """One bounded unit of background work; returns what happened:
        ``"idle"``, ``"fold-built"``, ``"fold-swapped"``, ``"tuning"``,
        ``"no-improvement"``, ``"built"``, ``"warmed"``, ``"swapped"`` or
        ``"stale-discarded"``. A step with nothing to do is a cheap
        no-op."""
        # background folds first: freshness debt grows with every append,
        # tuning can wait a step
        if self._gen is not None and self._gen.kind == "fold":
            return self._swap_pending()
        if self.platform.fold_due and self._gen is None \
                and self.state != "warmed":
            gen = self.platform.build_fold_generation()
            if gen is None:
                return "idle"
            self._warm_generation(gen)
            self._gen = gen
            return "fold-built"
        if self.state == "idle":
            return self._maybe_start_cycle()
        if self.state == "tuning":
            return self._tune_slice()
        if self.state == "won":
            theta, dscale, _ = self._winner
            self._gen = self.platform.build_generation(
                theta=theta, delta_scales=dscale)
            self.state = "built"
            return "built"
        if self.state == "built":
            self._warm_generation(self._gen)
            self.state = "warmed"
            return "warmed"
        if self.state == "warmed":
            return self._swap_pending()
        return "idle"

    def status(self) -> Dict:
        """Progress, for ``RetrievalServer.stats()``."""
        return {
            "state": self.state if self._gen is None or
            self._gen.kind != "fold" else "fold-pending",
            "generation": self.platform.generation,
            "build_id": self.platform.build_id,
            "swaps": self.n_swaps,
            "folds": self.n_folds,
            "cycles": self.cycles_run,
            "evals": 0 if self._driver is None else self._driver.n_evals,
            "fold_due": self.platform.fold_due,
            "warm_errors": len(self.warm_errors),
        }

    # --------------------------------------------------------- tuning
    def _maybe_start_cycle(self) -> str:
        qbs = self.platform.qbs
        if self.clock() - self._last_cycle < self.config.interval_s:
            return "idle"
        if sum(qbs.mix.values()) < self.config.min_queries:
            return "idle"
        snap = qbs.snapshot(max_queries=self.config.max_workload)
        if not snap.workload:
            return "idle"
        self._snapshot = snap
        self._workload = list(snap.workload)
        self._shadow = self._make_shadow()
        theta0, dscale0 = self.platform._transform_params
        self._baseline_y = self._evaluate(theta0, dscale0)
        self._sc_before = sc_score(self._shadow.enhanced,
                                   seed=self.config.seed)
        k = self.config.n_params
        lo = np.concatenate([np.full(k, -self.config.theta_range),
                             np.full(k, -self.config.scale_range)])
        self._driver = MorboDriver(
            (lo, -lo), n_objectives=3, n_init=self.config.n_init,
            n_tr=1, batch=2, seed=int(self._rng.integers(2 ** 31)))
        self._pending_x, self._pending_y = None, []
        self._cycles_done = 0
        self._last_cycle = self.clock()
        self.state = "tuning"
        return "tuning"

    def _tune_slice(self) -> str:
        """Evaluate at most ``evals_per_step`` candidates; close the
        ask/tell pair when its batch is done; finish the cycle after
        ``tune_cycles`` pairs."""
        if self._pending_x is None:
            self._pending_x = self._driver.ask()
            self._pending_y = []
        xb = self._pending_x
        k = self.config.n_params
        for _ in range(self.config.evals_per_step):
            i = len(self._pending_y)
            if i >= len(xb):
                break
            self._pending_y.append(self._evaluate(xb[i][:k], xb[i][k:]))
        if len(self._pending_y) < len(xb):
            return "tuning"
        self._driver.tell(np.stack(self._pending_y))
        self._pending_x = None
        self._cycles_done += 1
        if self._cycles_done <= self.config.tune_cycles:
            return "tuning"
        return self._finish_cycle()

    def _finish_cycle(self) -> str:
        self.cycles_run += 1
        res = self._driver.result()
        scores = np.array([self._scalarize(y) for y in res.y])
        best = int(np.argmin(scores))
        base_score = self._scalarize(self._baseline_y)
        improvement = base_score - scores[best]
        k = self.config.n_params
        theta = res.x[best][:k]
        dscale = res.x[best][k:]
        params = {"theta": [float(v) for v in theta],
                  "delta_scales": [float(v) for v in dscale]}
        if improvement <= self.config.min_improvement * abs(base_score):
            # the best candidate's parameters are kept (the reference
            # records none here), so a caller can still build it
            self.history.append(ReoptEvent(
                kind="no-improvement", params=params,
                baseline=[float(v) for v in self._baseline_y],
                best=[float(v) for v in res.y[best]],
                sc_before=self._sc_before, ts=time.time()))
            self._reset_cycle()
            return "no-improvement"
        # the winner's enhanced space scored (measurement.py) on the
        # shadow sample the objectives were measured on
        self._shadow.prepare(theta=theta, delta_scales=dscale,
                             **self.platform._prepare_cfg)
        sc_after = sc_score(self._shadow.enhanced, seed=self.config.seed)
        self._winner = (theta, dscale, res.y[best])
        self.history.append(ReoptEvent(
            kind="winner", params=params,
            baseline=[float(v) for v in self._baseline_y],
            best=[float(v) for v in res.y[best]],
            sc_before=self._sc_before, sc_after=sc_after,
            ts=time.time()))
        self.state = "won"
        return "tuning"

    def _reset_cycle(self):
        self.state = "idle"
        self._driver = None
        self._snapshot = None
        self._shadow = None
        self._workload = []
        self._pending_x, self._pending_y = None, []
        self._winner = None

    # ------------------------------------------------------ evaluation
    def _make_shadow(self) -> MQRLD:
        """A small platform over a sample of the live view on the
        platform's device: the tuner's measurement bench, made once per
        cycle and re-prepared per candidate."""
        v = self.platform.view()
        n = v.n_rows
        idx = np.sort(self._rng.choice(
            n, size=min(self.config.sample_rows, n), replace=False))
        tbl = MMOTable(
            name=v.name,
            numeric={k: np.ascontiguousarray(col[idx])
                     for k, col in v.numeric.items()},
            vector={k: np.ascontiguousarray(col[idx])
                    for k, col in v.vector.items()},
            embed_model=dict(v.embed_model))
        return MQRLD(tbl, seed=self.platform.seed,
                     device=self.platform.device)

    def _evaluate(self, theta, dscale) -> np.ndarray:
        """(mean time, mean CBR, -mean accuracy) of the workload snapshot
        on the shadow re-prepared with the candidate transform, measured
        against the shadow's own oracle on its scalar path."""
        sh = self._shadow
        sh.prepare(theta=None if theta is None else list(theta),
                   delta_scales=None if dscale is None else list(dscale),
                   **self.platform._prepare_cfg)
        times, cbrs, accs = [], [], []
        for q in self._workload:
            rows, st = sh.execute(q, record=False)
            truth = sh.oracle(q)
            times.append(st.time_s)
            cbrs.append(st.cbr)
            accs.append(accuracy(rows, truth))
        return np.array([float(np.mean(times)), float(np.mean(cbrs)),
                         -float(np.mean(accs))])

    def _scalarize(self, y: np.ndarray) -> float:
        """Baseline-normalized mean: each objective in units of the
        serving configuration's own magnitude, so seconds and ratios are
        commensurable."""
        b = np.maximum(np.abs(self._baseline_y), 1e-9)
        return float(np.mean(np.asarray(y, np.float64) / b))

    # -------------------------------------------------------- install
    def _warm_generation(self, gen: Generation):
        """Prewarm plans and device state for the incoming generation, so
        the swap causes no cold-plan or cold-engine stall. A failure
        here never blocks the swap: the engine is dropped and the error
        kept in ``warm_errors``."""
        sess = self.session
        queries = []
        if self._snapshot is not None:
            queries = list(self._snapshot.workload)
        elif self.platform.qbs.workload:
            queries = list(self.platform.qbs.snapshot(
                max_queries=self.config.max_workload).workload)
        if sess is None or not queries:
            return
        sess.prewarm(queries, build_id=self.platform.build_id + 1,
                     sizes=self.config.prewarm_sizes)
        try:
            from repro_torch.core.engine import HybridEngine, plannable
            shards = sess.shards or None
            key = self.platform._engine_key(sess.beam, sess.tile,
                                            sess.precision, shards)
            eng = HybridEngine(
                gen.tree, gen.table, gen.meta, beam=sess.beam,
                tile=sess.tile, device_loop=sess.device_loop,
                device=self.platform.device, precision=sess.precision,
                quant_cache=None, shards=shards)
            warm = [q for q in queries if plannable(q)][:4]
            if warm:
                eng.execute_batch(warm)
            gen.engines[key] = eng
        except Exception as e:   # the swap goes ahead with a cold engine
            gen.engines.clear()
            self.warm_errors.append(f"{type(e).__name__}: {e}")

    def _swap_pending(self) -> str:
        gen = self._gen
        self._gen = None
        was_fold = gen.kind == "fold"
        try:
            gid = self.platform.swap(gen)
        except RuntimeError:
            # the serving index changed under the build (an inline fold,
            # a prepare, another swap): drop it and start over
            if not was_fold:
                self._reset_cycle()
            return "stale-discarded"
        if was_fold:
            self.n_folds += 1
            self.history.append(ReoptEvent(
                kind="fold", gen_id=gid, ts=time.time()))
            return "fold-swapped"
        self.n_swaps += 1
        theta, dscale, y = self._winner
        self.history.append(ReoptEvent(
            kind="swap", gen_id=gid,
            params={"theta": [float(v) for v in theta],
                    "delta_scales": [float(v) for v in dscale]},
            baseline=[float(v) for v in self._baseline_y],
            best=[float(v) for v in y], ts=time.time()))
        self._reset_cycle()
        return "swapped"
