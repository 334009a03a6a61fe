"""MOAPI v2 query planner: ``Session.plan(queries) -> ExecutablePlan``.
Port of ``repro/core/planner.py``.

Per batch: ``Q.normalize`` -> ``Q.signature`` -> a ``LogicalPlan``
(per-query fragment, V.K job layout, KNN grouping), cached per (batch
signatures, loop kind, shard count, scan precision, platform build id)
-> an
``ExecutablePlan`` bound to this batch's constants, which runs through
``HybridEngine`` with beam seeds read from the QBS convergence rings and
records its widths, stage costs and workload back. An append does not
invalidate a cached plan (only a fold or ``prepare`` bumps the build
id): the engine unions the delta in at execute time, widths recorded
while it is live key on the archetype plus ``:delta``, and
``explain()["delta"]`` reports it.

The session's ``precision`` ("fp32", "bf16", "int8"; resolved by the
platform: explicit > ``MQRLD_PRECISION`` > ``default_precision``) picks
the KNN scan; the session counts the mixed-precision work over its
lifetime and ``explain()`` reports it.

Queries the engine cannot plan (a V.K under an Or under an And, for
one) take the scalar path, ``MQRLD.execute(q, record=False)``, after the
engine's batch; ``explain()`` reports them as path "scalar".

Calibrated cost model (``core/cost.py``): with a reliably fitted model
on the platform, ``Session.plan`` picks the beam loop by the least
predicted KNN cost (``_cost_choice``), ``_seeds`` keeps a QBS beam seed
only where the model predicts it cheaper than none, and every executed
plan gives the model its online refit. An explicit ``device_loop``
always wins; without a model, or while the session's own loop kind is
unfitted or unreliable, plans are byte-identical to the fixed
behaviour. ``explain()["cost_model"]`` reports the calibration and how
this plan's loop was chosen.

``ExecutablePlan.execute_async()`` is the serving pipeline's split of
``execute()``: it enqueues the engine fragments' device work and returns
a ``PendingExecution`` whose ``materialize()`` takes the fences, runs
the scalar fallbacks and makes every QBS write; its rows and stats are
``execute()``'s. ``Session.signature`` is the key the retrieval server
coalesces requests by, and ``Session.prewarm`` inserts plan skeletons
ahead of use. ``explain()`` reports each fragment's served latency.

Sharded sessions (``Session(shards=S)``): the device loop runs over S
shards of the tile layout; each shard count has its own plans and QBS
archetype keys (``:sS``: widths are per-shard tile counts), and
``explain()["shards"]`` reports it. Host-loop plans always carry 0. A
session whose shard count nobody pinned (``auto_topology``) lets the
calibrated model choose among every shard count it has a reliable kind
for; a pinned one chooses between the host loop and its own count.
Results are the same rows at every shard count.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost as costm
from repro_torch.core import query as Q
from repro_torch.core.engine import (_VR_DENSE_CUTOFF, EnginePlan,
                                     EngineStats, KnnGroupSpec,
                                     group_job_specs, plannable)
from repro_torch.utils import tracing


@dataclass(frozen=True)
class FragmentPlan:
    """Plan for one query of the batch."""
    signature: str
    path: str                       # "device-loop" | "host-loop" | "scalar"
    job_slots: Tuple[int, ...]      # this query's V.K job indices


@dataclass(frozen=True)
class LogicalPlan:
    """The cached, constants-free plan skeleton for one batch archetype."""
    signatures: Tuple[str, ...]
    device_loop: bool
    fragments: Tuple[FragmentPlan, ...]
    engine_idx: Tuple[int, ...]     # positions routed to the engine
    scalar_idx: Tuple[int, ...]     # positions needing the scalar path
    job_specs: Tuple[Tuple[str, int, bool], ...]   # (attr, k, masked)/job
    groups: Tuple[KnnGroupSpec, ...]
    shards: int = 0       # the device loop's shard count (0: one device)


def _collect_job_specs(q: Q.Query, ambient: bool,
                       out: List[Tuple[str, int, bool]]):
    """Mirror of ``HybridEngine._walk``'s V.K registration order over an
    engine-plannable tree, shape-only: (attr, k, masked) per job."""
    if isinstance(q, Q.VK):
        out.append((q.attr, q.k, ambient))
        return
    if isinstance(q, (Q.NE, Q.NR, Q.VR)):
        return
    if isinstance(q, Q.And):
        vks = [p for p in q.parts if isinstance(p, Q.VK)]
        preds = [p for p in q.parts if not isinstance(p, Q.VK)]
        amb = ambient or bool(preds)
        for p in preds:
            _collect_job_specs(p, ambient, out)
        for p in vks:
            out.append((p.attr, p.k, amb))
        return
    if isinstance(q, Q.Or):
        for p in q.parts:
            _collect_job_specs(p, ambient, out)
        return
    raise TypeError(q)


def build_logical_plan(norm: Sequence[Q.Query], device_loop: bool,
                       shards: int = 0) -> LogicalPlan:
    """Derive the plan skeleton for one batch of normalized queries."""
    sigs = tuple(Q.signature(q) for q in norm)
    engine_idx, scalar_idx = [], []
    fragments: List[FragmentPlan] = []
    job_specs: List[Tuple[str, int, bool]] = []
    loop_name = "device-loop" if device_loop else "host-loop"
    for i, q in enumerate(norm):
        if plannable(q):
            engine_idx.append(i)
            n0 = len(job_specs)
            _collect_job_specs(q, False, job_specs)
            fragments.append(FragmentPlan(
                signature=sigs[i], path=loop_name,
                job_slots=tuple(range(n0, len(job_specs)))))
        else:
            scalar_idx.append(i)
            fragments.append(FragmentPlan(
                signature=sigs[i], path="scalar", job_slots=()))
    eff = shards if device_loop else 0
    return LogicalPlan(
        signatures=sigs, device_loop=device_loop,
        fragments=tuple(fragments), engine_idx=tuple(engine_idx),
        scalar_idx=tuple(scalar_idx), job_specs=tuple(job_specs),
        groups=group_job_specs(tuple(job_specs), device_loop, eff),
        shards=eff)


def _delta_suffix(platform) -> str:
    """The QBS key suffix of KNN archetypes while un-folded delta rows
    are unioned in (``HybridEngine._run_jobs`` records under it)."""
    return ":delta" if platform.n_delta else ""


def _knn_group_features(eng, grp: KnnGroupSpec, device_loop: bool,
                        shards: int, beam: int, precision: str,
                        seed: Optional[int] = None) -> Tuple[float, ...]:
    """Plan-time cost features for one KNN group, read off the layout
    the loop would scan: the features the engine records its observed
    seconds against. Any engine prices every shard count: the sharded
    loop's per-shard tile count is ceil(T / shards), the strided
    layout's t_local."""
    geom = eng.geom_dev[grp.attr] if device_loop else eng.geom[grp.attr]
    tiles = geom.n_leaves
    if device_loop and shards:
        tiles = -(-tiles // max(1, int(shards)))
    return costm.knn_plan_features(
        device_loop=device_loop, shards=shards if device_loop else 0,
        g=len(grp.jobs), k=grp.kmax, beam=beam, tiles=tiles, cap=geom.cap,
        dim=eng.vec_np[grp.attr].shape[1], precision=precision, seed=seed)


class PendingExecution:
    """Deferred epilogue of ``ExecutablePlan.execute_async()``: the
    engine's ``PendingBatch``, the scalar fallbacks and the QBS writes,
    all in ``materialize()``, the only place the batch takes a device
    fence after its dispatch. Idempotent: repeated calls return the same
    (results, stats) and record once."""

    __slots__ = ("_fn", "_res")

    def __init__(self, fn):
        self._fn = fn
        self._res = None

    def materialize(self) -> Tuple[List[np.ndarray], EngineStats]:
        if self._res is None:
            self._res = self._fn()
        return self._res


class ExecutablePlan:
    """A ``LogicalPlan`` bound to one batch of queries, ready to run.
    ``choices`` records how its loop was decided: "explicit" (the caller
    pinned it), "default" (the session's) or "cost_model" with each
    candidate's prediction."""

    def __init__(self, session: "Session", logical: LogicalPlan,
                 queries: Sequence[Q.Query], norm: Sequence[Q.Query],
                 cache_hit: bool, choices: Optional[dict] = None):
        self.session = session
        self.logical = logical
        self.queries = list(queries)
        self.norm = list(norm)
        self.cache_hit = cache_hit
        self.choices = choices or {"by": "default"}

    def _seeds(self) -> Dict[str, int]:
        """QBS convergence seeds for this plan's KNN groups, looked up at
        execute time so a cached plan keeps learning between runs. While
        un-folded delta rows exist, the engine records (and this looks
        up) each archetype's ``:delta`` variant, so delta-widened widths
        never reach the base seed. With a reliably fitted model for the
        plan's loop, a seed is dropped where the model predicts the
        unseeded widths cheaper (seeds only move work between beam
        rounds)."""
        sess = self.session
        qbs = sess.platform.qbs
        lp = self.logical
        suffix = _delta_suffix(sess.platform)
        seeds: Dict[str, int] = {}
        for grp in lp.groups:
            w = qbs.convergence_width(grp.archetype + suffix)
            if w is not None:
                seeds[grp.archetype + suffix] = w
        cm = sess.platform.cost_model
        kind = costm.knn_kind(lp.device_loop, lp.shards)
        if cm is not None and seeds and cm.reliable(kind):
            eng = sess.engine(lp.shards)
            for grp in lp.groups:
                key = grp.archetype + suffix
                if key not in seeds:
                    continue
                ps = cm.predict(kind, _knn_group_features(
                    eng, grp, lp.device_loop, lp.shards, sess.beam,
                    sess.precision, seed=seeds[key]))
                pn = cm.predict(kind, _knn_group_features(
                    eng, grp, lp.device_loop, lp.shards, sess.beam,
                    sess.precision))
                if ps is not None and pn is not None and pn < ps:
                    seeds.pop(key)
        return seeds

    def execute(self) -> Tuple[List[np.ndarray], EngineStats]:
        """(results, EngineStats): one row array per query in submission
        order — exactly the rows of the brute-force oracle. Engine
        fragments run as one batch, then each unplannable query on the
        scalar path (its work is not in the engine's counters)."""
        with tracing.span("planner.execute"):
            lp = self.logical
            p = self.session.platform
            t0 = time.time()
            results: List[Optional[np.ndarray]] = [None] * len(self.norm)
            if lp.engine_idx:
                eng_plan = EnginePlan(
                    device_loop=lp.device_loop, job_specs=lp.job_specs,
                    groups=lp.groups, seeds=self._seeds(), shards=lp.shards,
                    precision=self.session.precision)
                eng = self.session.engine(lp.shards)
                rows, stats = eng.execute_batch(
                    [self.norm[i] for i in lp.engine_idx], plan=eng_plan)
                with tracing.span("planner.record"):
                    for i, r in zip(lp.engine_idx, rows):
                        results[i] = r
                    for arch, width in stats.knn_group_widths:
                        p.qbs.record_convergence(arch, width)
                    for kind, feats, secs in stats.stage_samples:
                        p.qbs.record_cost(kind, feats, secs)
                    if p.cost_model is not None and stats.stage_samples:
                        p.cost_model.maybe_refit(p.qbs)
                    self.session.mp_scanned += stats.mp_scanned
                    self.session.mp_rescued += stats.mp_rescued
            else:
                stats = EngineStats()
            stats.queries = len(self.norm)
            for i in lp.scalar_idx:
                results[i] = p.execute(self.norm[i], record=False)[0]
            stats.time_s = time.time() - t0
            with tracing.span("planner.record"):
                # tuner feedback: one representative AST per signature per
                # batch
                reps: Dict[str, list] = {}
                for q, frag in zip(self.norm, lp.fragments):
                    slot = reps.setdefault(frag.signature, [q, 0])
                    slot[1] += 1
                for sig, (q, cnt) in reps.items():
                    p.qbs.record_workload(sig, q, cnt)
            return results, stats  # type: ignore[return-value]

    def execute_async(self, *, record: bool = True) -> PendingExecution:
        """Dispatch half of ``execute()`` for the serving pipeline: the
        engine fragments' predicate masks and each KNN group's first round
        are enqueued (``HybridEngine.execute_batch_async``) and this
        returns. ``materialize()`` of the result takes each group's fence,
        runs the straggler rounds, the finishing walk and the scalar
        fallbacks, and makes every QBS write (convergence widths,
        workload), so rings change only on the stage that retires the
        batch; its rows and stats are ``execute()``'s. Not recorded here:
        the stages' wall-time cost samples (under overlap they time other
        batches too), so ``execute()`` stays the cost model's sample
        source. ``record=False`` records nothing at all (the pipeline's
        shape prewarming)."""
        lp = self.logical
        p = self.session.platform
        t0 = time.time()
        pending = None
        if lp.engine_idx:
            eng_plan = EnginePlan(
                device_loop=lp.device_loop, job_specs=lp.job_specs,
                groups=lp.groups, seeds=self._seeds(), shards=lp.shards,
                precision=self.session.precision)
            pending = self.session.engine(lp.shards).execute_batch_async(
                [self.norm[i] for i in lp.engine_idx], plan=eng_plan)
        t_disp = time.time() - t0

        def _materialize() -> Tuple[List[np.ndarray], EngineStats]:
            t1 = time.time()
            results: List[Optional[np.ndarray]] = [None] * len(self.norm)
            if pending is not None:
                rows, stats = pending.materialize()
                for i, r in zip(lp.engine_idx, rows):
                    results[i] = r
                if record:
                    for arch, width in stats.knn_group_widths:
                        p.qbs.record_convergence(arch, width)
                    self.session.mp_scanned += stats.mp_scanned
                    self.session.mp_rescued += stats.mp_rescued
            else:
                stats = EngineStats()
            stats.queries = len(self.norm)
            for i in lp.scalar_idx:
                results[i] = p.execute(self.norm[i], record=False)[0]
            stats.time_s = t_disp + (time.time() - t1)
            if record:
                reps: Dict[str, list] = {}
                for q, frag in zip(self.norm, lp.fragments):
                    slot = reps.setdefault(frag.signature, [q, 0])
                    slot[1] += 1
                for sig, (q, cnt) in reps.items():
                    p.qbs.record_workload(sig, q, cnt)
            return results, stats  # type: ignore[return-value]

        return PendingExecution(_materialize)

    def explain(self) -> dict:
        """Structured plan description (no execution): path per query,
        cache hit/miss, per-V.K group/archetype/beam seed, per-V.R
        surviving-tile estimate and route, and the un-folded delta the
        execution would union in (epoch, live rows, host-layout tiles),
        read at explain time so a cached plan reports fresh writes."""
        lp = self.logical
        seeds = self._seeds()
        sess = self.session
        qbs = sess.platform.qbs
        suffix = _delta_suffix(sess.platform)
        eng = sess.engine(lp.shards) if lp.engine_idx else None
        cm = sess.platform.cost_model
        # predicted (None without a model or fit) and observed (the
        # median of the kind's QBS cost ring) seconds per KNN group
        kind = costm.knn_kind(lp.device_loop, lp.shards)
        grp_cost = {}
        for gi, grp in enumerate(lp.groups):
            pred = None
            if cm is not None and eng is not None:
                pred = cm.predict(kind, _knn_group_features(
                    eng, grp, lp.device_loop, lp.shards, sess.beam,
                    sess.precision, seed=seeds.get(grp.archetype + suffix)))
            grp_cost[gi] = {"kind": kind, "predicted_s": pred,
                            "observed_s": qbs.cost_observed(kind)}
        job_of_group = {j: gi for gi, grp in enumerate(lp.groups)
                        for j in grp.jobs}
        frags = []
        for frag, q in zip(lp.fragments, self.norm):
            knn = []
            for slot in frag.job_slots:
                gi = job_of_group[slot]
                grp = lp.groups[gi]
                attr, k, masked = lp.job_specs[slot]
                knn.append({"attr": attr, "k": k, "masked": masked,
                            "group": gi, "archetype": grp.archetype + suffix,
                            "beam_seed": seeds.get(grp.archetype + suffix),
                            "cost": grp_cost[gi]})
            vr = []
            if eng is not None and frag.path != "scalar":
                for b in Q.basic_queries(q):
                    if isinstance(b, Q.VR):
                        vr.append(self._vr_entry(eng, b, cm))
            frags.append({"query": frag.signature, "path": frag.path,
                          "knn": knn, "vr": vr,
                          # {p50, p99, n} of the per-request service
                          # seconds the retrieval server recorded for this
                          # signature (None until it was served)
                          "latency": qbs.latency_quantiles(frag.signature)})
        rescue = {
            "scanned": sess.mp_scanned,
            "rescued": sess.mp_rescued,
            "ratio": (sess.mp_rescued / sess.mp_scanned
                      if sess.mp_scanned else 0.0),
        }
        p = sess.platform
        delta = {
            "epoch": p.delta_epoch,
            "rows": p.n_delta,
            "tiles": (eng.delta_tiles if eng is not None
                      else (0 if p.delta is None
                            else p.delta.n_tiles(sess.tile))),
        }
        return {
            "cache": "hit" if self.cache_hit else "miss",
            "device_loop": lp.device_loop,
            "shards": lp.shards,
            "device": str(sess.platform.device),
            # calibration state and how this plan's loop was chosen
            "cost_model": {
                "calibrated": cm is not None and cm.calibrated(),
                "kinds": sorted(cm.kinds) if cm is not None else [],
                "choices": self.choices,
            },
            "precision": sess.precision,
            # fp32-rescue pressure of the mixed-precision scan, summed
            # over every batch this session executed (all zero on fp32)
            "rescue": rescue,
            "build_id": sess.platform.build_id,
            "delta": delta,
            "n_queries": len(self.norm),
            "n_engine": len(lp.engine_idx),
            "n_scalar": len(lp.scalar_idx),
            "knn_groups": [
                {"attr": g.attr, "kmax": g.kmax, "jobs": len(g.jobs),
                 "masked": g.n_masked, "archetype": g.archetype + suffix,
                 "beam_seed": seeds.get(g.archetype + suffix)}
                for g in lp.groups],
            "fragments": frags,
        }

    def _vr_entry(self, eng, b: Q.VR, cm) -> dict:
        """One V.R's pruned-tile estimate and route preview, mirroring
        ``HybridEngine._vr_masks`` for this query alone (the executed
        group unions the survivors of all its queries)."""
        survive, total = eng.vr_tile_estimate(b)
        dim = eng.vec_np[b.attr].shape[1]
        pd = pt = None
        if cm is not None and self.logical.device_loop:
            pd = cm.predict("vr:dense", costm.vr_features(
                "vr:dense", 1, survive, eng.cap, dim, eng.n))
            pt = cm.predict("vr:tile", costm.vr_features(
                "vr:tile", 1, survive, eng.cap, dim, eng.n))
        if not self.logical.device_loop:
            route = "dense"
        elif pd is not None and pt is not None \
                and cm.reliable("vr:dense", "vr:tile"):
            route = "dense" if pd <= pt else "tile"
        else:
            route = "dense" if survive * eng.cap > \
                _VR_DENSE_CUTOFF * max(1, eng.n) else "tile"
        qbs = self.session.platform.qbs
        return {"attr": b.attr, "tiles_surviving": survive,
                "tiles_pruned": total - survive, "tiles_total": total,
                "route": route,
                "cost": {"predicted_dense_s": pd, "predicted_tile_s": pt,
                         "route": route,
                         "observed_dense_s": qbs.cost_observed("vr:dense"),
                         "observed_tile_s": qbs.cost_observed("vr:tile")}}


class Session:
    """One planning/execution context over a prepared ``MQRLD`` platform:
    the plan cache (keyed on batch signatures + loop kind + shard count +
    precision + platform build id) and the engine configuration.
    ``shards``: None takes the platform's ``default_shards``, 0 (or None
    there) one device, S >= 1 the sharded device loop over S shards;
    ``auto_topology`` lets the calibrated model choose the shard count
    (``MQRLD.session`` sets it when nobody pinned one)."""

    def __init__(self, platform, *, device_loop: bool = True,
                 beam: int = 16, tile: int = 128,
                 shards: Optional[int] = None,
                 precision: Optional[str] = None,
                 auto_topology: bool = False):
        self.platform = platform
        self.device_loop = device_loop
        self.beam = beam
        self.tile = tile
        self.auto_topology = auto_topology
        # resolved here so plan keys and the executing engine never
        # disagree
        if shards is None:
            shards = platform.default_shards
        self.shards: Optional[int] = shards or None
        # resolved here (explicit > MQRLD_PRECISION > platform default)
        # so plan keys and the executing engine never disagree
        self.precision = platform._resolve_precision(precision)
        # session-lifetime mixed-precision counters (explain()'s rescue
        # block): rescued/scanned over every batch this session ran
        self.mp_scanned = 0
        self.mp_rescued = 0
        self._cache: Dict[Tuple, LogicalPlan] = {}
        self._cache_build = platform.build_id
        self.cache_hits = 0
        self.cache_misses = 0

    def engine(self, shards: Optional[int] = None):
        """The engine of this session's shard count, or of a plan's own
        (``ExecutablePlan`` passes ``lp.shards``: host-loop plans carry 0,
        so the oracle path never builds a sharded engine)."""
        if shards is None:
            shards = self.shards or 0
        return self.platform.engine(beam=self.beam, tile=self.tile,
                                    shards=shards, precision=self.precision)

    def _cost_choice(self, norm: Sequence[Q.Query]
                     ) -> Optional[Tuple[bool, dict]]:
        """The loop and shard count of least predicted KNN cost for one
        batch, as (device_loop, provenance; its ``chosen`` holds the
        shard count), or None when no choice can be made: no fitted
        model, no plannable V.K work, the session's own kind unfitted or
        unreliable, or fewer than two candidates priced. Candidates: the
        host loop; the single-device loop unless a shard count is pinned;
        the pinned shard count; with ``auto_topology``, every shard count
        the model has a kind for (any runs on the devices there are)."""
        cm = self.platform.cost_model
        if cm is None or not cm.calibrated():
            return None
        specs: List[Tuple[str, int, bool]] = []
        for q in norm:
            if plannable(q):
                _collect_job_specs(q, False, specs)
        if not specs:
            return None
        own = (self.shards or 0) if self.device_loop else 0
        if not cm.reliable(costm.knn_kind(self.device_loop, own)):
            return None
        cands = [(False, 0)]
        if self.auto_topology or not self.shards:
            cands.append((True, 0))
        if self.shards:
            cands.append((True, self.shards))
        if self.auto_topology:
            for kind in cm.kinds:
                s = costm.shards_of_kind(kind)
                if s and s >= 1 and (True, s) not in cands:
                    cands.append((True, s))
        eng = self.engine(0)   # the single-device layouts price them all
        suffix = _delta_suffix(self.platform)
        scored = []
        for dl, sh in cands:
            kind = costm.knn_kind(dl, sh)
            if not cm.reliable(kind):
                continue
            total = 0.0
            for grp in group_job_specs(tuple(specs), dl, sh):
                seed = self.platform.qbs.convergence_width(
                    grp.archetype + suffix)
                pred = cm.predict(kind, _knn_group_features(
                    eng, grp, dl, sh, self.beam, self.precision,
                    seed=seed))
                if pred is None:
                    total = None
                    break
                total += pred
            if total is not None:
                scored.append((total, dl, sh, kind))
        if len(scored) < 2:
            return None
        scored.sort(key=lambda t: t[0])
        best = scored[0]
        return best[1], {
            "by": "cost_model",
            "candidates": [{"device_loop": dl, "shards": sh, "kind": kind,
                            "predicted_s": tot}
                           for tot, dl, sh, kind in scored],
            "chosen": {"device_loop": best[1], "shards": best[2]}}

    def plan(self, queries: Sequence[Q.Query], *,
             device_loop: Optional[bool] = None) -> ExecutablePlan:
        """Normalize + sign the batch and return an ``ExecutablePlan``,
        reusing the cached skeleton for a batch archetype planned before
        under the same loop kind, shard count and index build. The loop
        and shard count: an explicit ``device_loop`` wins (with the
        session's shard count on the device loop), then the cost model's
        choice (``_cost_choice``), then the session's defaults."""
        with tracing.span("planner.plan"):
            norm = [Q.normalize(q) for q in queries]
            choices: Optional[dict] = None
            if device_loop is not None:
                dl = device_loop
                shards = (self.shards or 0) if dl else 0
                choices = {"by": "explicit"}
            else:
                sel = self._cost_choice(norm)
                if sel is not None:
                    dl, choices = sel
                    shards = choices["chosen"]["shards"]
                else:
                    dl = self.device_loop
                    shards = (self.shards or 0) if dl else 0
            if self._cache_build != self.platform.build_id:
                # entries of dead builds go; entries prewarmed for this build
                # (keyed on it before it was installed) stay
                b = self.platform.build_id
                self._cache = {k: v for k, v in self._cache.items()
                               if k[-1] == b}
                self._cache_build = b
            key = (tuple(Q.signature(q) for q in norm), dl, shards,
                   self.precision, self.platform.build_id)
            logical = self._cache.get(key)
            hit = logical is not None
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
                logical = build_logical_plan(norm, dl, shards)
                self._cache[key] = logical
            return ExecutablePlan(self, logical, queries, norm, hit,
                                  choices=choices)

    def prewarm(self, queries: Sequence[Q.Query], *,
                build_id: Optional[int] = None,
                device_loop: Optional[bool] = None,
                sizes: Sequence[int] = (1,)) -> int:
        """Insert the plan skeletons of batches of ``sizes`` copies of each
        query's shape, keyed under ``build_id`` (default: the current
        build), so the first batch of each is a plan-cache hit. Returns the
        number of skeletons inserted (shapes already cached are
        skipped)."""
        dl = self.device_loop if device_loop is None else device_loop
        shards = (self.shards or 0) if dl else 0
        b = self.platform.build_id if build_id is None else build_id
        n_new = 0
        for q in queries:
            norm = Q.normalize(q)
            sig = Q.signature(norm)
            for size in sizes:
                key = ((sig,) * int(size), dl, shards, self.precision, b)
                if key not in self._cache:
                    self._cache[key] = build_logical_plan(
                        [norm] * int(size), dl, shards)
                    n_new += 1
        return n_new

    def signature(self, query: Q.Query) -> str:
        """The archetype string ``plan()`` keys this query under
        (normalize + ``Q.signature``), which the retrieval server
        coalesces requests by. Vector constants are elided, so a
        placeholder vector signs a request before its embedding exists."""
        return Q.signature(Q.normalize(query))

    def execute(self, queries: Sequence[Q.Query], *,
                device_loop: Optional[bool] = None
                ) -> Tuple[List[np.ndarray], EngineStats]:
        return self.plan(queries, device_loop=device_loop).execute()

    def explain(self, queries: Sequence[Q.Query], *,
                device_loop: Optional[bool] = None) -> dict:
        return self.plan(queries, device_loop=device_loop).explain()
