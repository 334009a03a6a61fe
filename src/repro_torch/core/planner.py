"""MOAPI v2 query planner: ``Session.plan(queries) -> ExecutablePlan``.
Port of ``repro/core/planner.py`` for one device.

Per batch: ``Q.normalize`` -> ``Q.signature`` -> a ``LogicalPlan``
(per-query fragment, V.K job layout, KNN grouping), cached per (batch
signatures, loop kind, scan precision, platform build id) -> an
``ExecutablePlan`` bound to this batch's constants, which runs through
``HybridEngine`` with beam seeds read from the QBS convergence rings and
records its widths, stage costs and workload back.

The session's ``precision`` ("fp32", "bf16", "int8"; resolved by the
platform: explicit > ``MQRLD_PRECISION`` > ``default_precision``) picks
the KNN scan; the session counts the mixed-precision work over its
lifetime and ``explain()`` reports it.

Not in this slice: the calibrated cost model (no model is attached, so
the session's loop applies, as on an uncalibrated reference platform),
sharded topologies, the async executor, and the scalar fallback for
queries the engine cannot plan (``execute`` raises
``NotImplementedError`` for those).
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


def build_logical_plan(norm: Sequence[Q.Query],
                       device_loop: bool) -> LogicalPlan:
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
    return LogicalPlan(
        signatures=sigs, device_loop=device_loop,
        fragments=tuple(fragments), engine_idx=tuple(engine_idx),
        scalar_idx=tuple(scalar_idx), job_specs=tuple(job_specs),
        groups=group_job_specs(tuple(job_specs), device_loop))


class ExecutablePlan:
    """A ``LogicalPlan`` bound to one batch of queries, ready to run."""

    def __init__(self, session: "Session", logical: LogicalPlan,
                 queries: Sequence[Q.Query], norm: Sequence[Q.Query],
                 cache_hit: bool):
        self.session = session
        self.logical = logical
        self.queries = list(queries)
        self.norm = list(norm)
        self.cache_hit = cache_hit

    def _seeds(self) -> Dict[str, int]:
        """QBS convergence seeds for this plan's KNN groups, looked up at
        execute time so a cached plan keeps learning between runs."""
        qbs = self.session.platform.qbs
        seeds: Dict[str, int] = {}
        for grp in self.logical.groups:
            w = qbs.convergence_width(grp.archetype)
            if w is not None:
                seeds[grp.archetype] = w
        return seeds

    def execute(self) -> Tuple[List[np.ndarray], EngineStats]:
        """(results, EngineStats): one row array per query in submission
        order — exactly the rows of the brute-force oracle."""
        lp = self.logical
        p = self.session.platform
        if lp.scalar_idx:
            raise NotImplementedError(
                "the scalar executor (MQRLD.execute) is not ported yet; "
                "not plannable for the batched engine: "
                f"{[self.norm[i] for i in lp.scalar_idx]!r}")
        t0 = time.time()
        results: List[Optional[np.ndarray]] = [None] * len(self.norm)
        if lp.engine_idx:
            eng_plan = EnginePlan(
                device_loop=lp.device_loop, job_specs=lp.job_specs,
                groups=lp.groups, seeds=self._seeds(),
                precision=self.session.precision)
            eng = self.session.engine()
            rows, stats = eng.execute_batch(
                [self.norm[i] for i in lp.engine_idx], plan=eng_plan)
            for i, r in zip(lp.engine_idx, rows):
                results[i] = r
            for arch, width in stats.knn_group_widths:
                p.qbs.record_convergence(arch, width)
            for kind, feats, secs in stats.stage_samples:
                p.qbs.record_cost(kind, feats, secs)
            self.session.mp_scanned += stats.mp_scanned
            self.session.mp_rescued += stats.mp_rescued
        else:
            stats = EngineStats()
        stats.queries = len(self.norm)
        stats.time_s = time.time() - t0
        # tuner feedback: one representative AST per signature per batch
        reps: Dict[str, list] = {}
        for q, frag in zip(self.norm, lp.fragments):
            slot = reps.setdefault(frag.signature, [q, 0])
            slot[1] += 1
        for sig, (q, cnt) in reps.items():
            p.qbs.record_workload(sig, q, cnt)
        return results, stats  # type: ignore[return-value]

    def explain(self) -> dict:
        """Structured plan description (no execution): path per query,
        cache hit/miss, per-V.K group/archetype/beam seed, per-V.R
        surviving-tile estimate and route."""
        lp = self.logical
        seeds = self._seeds()
        sess = self.session
        qbs = sess.platform.qbs
        eng = sess.engine() if lp.engine_idx else None
        kind = costm.knn_kind(lp.device_loop)
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
                            "group": gi, "archetype": grp.archetype,
                            "beam_seed": seeds.get(grp.archetype),
                            "cost": {"kind": kind, "predicted_s": None,
                                     "observed_s": qbs.cost_observed(kind)}})
            vr = []
            if eng is not None and frag.path != "scalar":
                for b in Q.basic_queries(q):
                    if isinstance(b, Q.VR):
                        survive, total = eng.vr_tile_estimate(b)
                        dense = survive * eng.cap > \
                            _VR_DENSE_CUTOFF * max(1, eng.n)
                        route = "dense" if dense or not lp.device_loop \
                            else "tile"
                        vr.append({"attr": b.attr,
                                   "tiles_surviving": survive,
                                   "tiles_pruned": total - survive,
                                   "tiles_total": total, "route": route})
            frags.append({"query": frag.signature, "path": frag.path,
                          "knn": knn, "vr": vr})
        rescue = {
            "scanned": sess.mp_scanned,
            "rescued": sess.mp_rescued,
            "ratio": (sess.mp_rescued / sess.mp_scanned
                      if sess.mp_scanned else 0.0),
        }
        return {
            "cache": "hit" if self.cache_hit else "miss",
            "device_loop": lp.device_loop,
            "device": str(sess.platform.device),
            "precision": sess.precision,
            # fp32-rescue pressure of the mixed-precision scan, summed
            # over every batch this session executed (all zero on fp32)
            "rescue": rescue,
            "build_id": sess.platform.build_id,
            "n_queries": len(self.norm),
            "n_engine": len(lp.engine_idx),
            "n_scalar": len(lp.scalar_idx),
            "knn_groups": [
                {"attr": g.attr, "kmax": g.kmax, "jobs": len(g.jobs),
                 "masked": g.n_masked, "archetype": g.archetype,
                 "beam_seed": seeds.get(g.archetype)}
                for g in lp.groups],
            "fragments": frags,
        }


class Session:
    """One planning/execution context over a prepared ``MQRLD`` platform:
    the plan cache (keyed on batch signatures + loop kind + precision +
    platform build id) and the engine configuration."""

    def __init__(self, platform, *, device_loop: bool = True,
                 beam: int = 16, tile: int = 128,
                 precision: Optional[str] = None):
        self.platform = platform
        self.device_loop = device_loop
        self.beam = beam
        self.tile = tile
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

    def engine(self):
        return self.platform.engine(beam=self.beam, tile=self.tile,
                                    precision=self.precision)

    def plan(self, queries: Sequence[Q.Query], *,
             device_loop: Optional[bool] = None) -> ExecutablePlan:
        """Normalize + sign the batch and return an ``ExecutablePlan``,
        reusing the cached skeleton for a batch archetype planned before
        under the same loop kind and index build."""
        norm = [Q.normalize(q) for q in queries]
        dl = self.device_loop if device_loop is None else device_loop
        if self._cache_build != self.platform.build_id:
            self._cache = {}
            self._cache_build = self.platform.build_id
        key = (tuple(Q.signature(q) for q in norm), dl, self.precision,
               self.platform.build_id)
        logical = self._cache.get(key)
        hit = logical is not None
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
            logical = build_logical_plan(norm, dl)
            self._cache[key] = logical
        return ExecutablePlan(self, logical, queries, norm, hit)

    def execute(self, queries: Sequence[Q.Query], *,
                device_loop: Optional[bool] = None
                ) -> Tuple[List[np.ndarray], EngineStats]:
        return self.plan(queries, device_loop=device_loop).execute()

    def explain(self, queries: Sequence[Q.Query], *,
                device_loop: Optional[bool] = None) -> dict:
        return self.plan(queries, device_loop=device_loop).explain()
