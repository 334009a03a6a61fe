"""Query Behavior Statistic (QBS) table — the query-aware mechanism
(paper §4.3, Table 3). Port of ``repro/core/qbs.py`` (numpy only).

Every query the scalar executor answers with recording on appends a row
(statement, object set, attributes, types, Recall@K, CBR, time,
accuracy), sampled at ``sample_rate`` from ``np.random.default_rng(seed)``
exactly as the reference draws, so both packages keep the same rows; the
rows feed the extrinsic score S1 (§5.1.2) and the optimizer's objectives.
Besides the rows the table holds the rings that a planned batch records
into and the planner reads back: per-archetype convergence widths (the
beam seeds of ``Session.plan``), per-stage cost samples (the cost
model's fit and online refit), per-signature workload samples, and
per-signature service latencies, which ``serve.RetrievalServer`` records
and reads back for deadline shedding and its adaptive window, and
``explain()`` reports. ``save`` / ``load`` write the reference's
``qbs.json`` (rows, convergence, latency and cost rings; the workload
ring holds live query objects and is not persisted), so a table saved by
either package loads in the other. ``snapshot()`` exports a
point-in-time copy of the mix, the rings and a hottest-first sample of
recent query ASTs (``QBSSnapshot``): the workload the online
re-optimization controller (``core/reopt.py``) tunes against.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class QBSRow:
    statement: str
    object_set: str            # table name
    attributes: List[str]
    types: List[str]           # e.g. ["NR", "VK"]
    recall_at_k: float
    cbr: float                 # cross-bucket rate: buckets touched / total
    query_time_s: float
    accuracy: float
    task: str = ""
    ts: float = 0.0


_CONVERGENCE_KEEP = 64  # recent widths kept per archetype (ring buffer)
_LATENCY_KEEP = 512     # recent service times kept per signature
_WORKLOAD_KEEP = 16     # recent executed query ASTs kept per signature
_ROWS_KEEP = 4096       # recent QBS rows kept: a long-lived process must
#                         not grow the row log (and the O(n) scans of
#                         extrinsic_score / objectives) without bound
_COST_KEEP = 256        # recent (features, seconds) samples per stage kind


@dataclass
class QBSSnapshot:
    """Point-in-time export of the query-aware state, what the online
    re-optimization controller tunes against (``QBSTable.snapshot``).
    ``workload`` samples recently executed query ASTs hottest signature
    first (round-robin across signatures by execution count), so the
    first K queries measure the traffic that dominates serving."""
    ts: float
    mix: Dict[str, int]                       # signature -> executed count
    convergence: Dict[str, List[int]]         # archetype -> widths (copy)
    latency: Dict[str, Dict[str, float]]      # signature -> {p50, p99, n}
    workload: List                            # sampled Q.Query objects
    n_rows: int = 0                           # QBS rows at snapshot time

    @property
    def total_executed(self) -> int:
        return sum(self.mix.values())


class QBSTable:
    def __init__(self, sample_rate: float = 1.0, seed: int = 0):
        self.rows: List[QBSRow] = []
        self.convergence: Dict[str, List[int]] = {}
        # plan signature -> recent per-request service seconds (micro-batch
        # wall time / batch size), most recent last
        self.latency: Dict[str, List[float]] = {}
        self.workload: Dict[str, List] = {}
        self.mix: Dict[str, int] = {}
        self.cost: Dict[str, List] = {}
        # monotone count of cost samples ever recorded (the rings saturate
        # at _COST_KEEP): the cost model's refit cursor
        self.cost_total: int = 0
        self.sample_rate = sample_rate
        self._rng = np.random.default_rng(seed)
        # every ring append/trim and every multi-ring reader runs under
        # this lock, so recording can never interleave a trim with an
        # append or lose a ``cost_total`` increment
        self._lock = threading.RLock()

    def __len__(self):
        return len(self.rows)

    def maybe_record(self, **kw) -> Optional[QBSRow]:
        """Sampled recording (paper §7.9: Recall@K and accuracy need the
        ground truth, so statistics are sampled)."""
        if self._rng.random() > self.sample_rate:
            return None
        return self.record(**kw)

    def record(self, *, statement: str, object_set: str,
               attributes: Sequence[str], types: Sequence[str],
               recall_at_k: float, cbr: float, query_time_s: float,
               accuracy: float, task: str = "") -> QBSRow:
        row = QBSRow(statement=statement, object_set=object_set,
                     attributes=list(attributes), types=list(types),
                     recall_at_k=float(recall_at_k), cbr=float(cbr),
                     query_time_s=float(query_time_s),
                     accuracy=float(accuracy), task=task, ts=time.time())
        with self._lock:
            self.rows.append(row)
            if len(self.rows) > _ROWS_KEEP:
                del self.rows[:len(self.rows) - _ROWS_KEEP]
        return row

    # ------------------------------------------- plan-parameter feedback
    def record_convergence(self, archetype: str, width: int):
        """Record the beam width (in tiles, beyond the first round) at
        which one executed KNN group converged. Zero is a real signal and
        is stored as such, so the seed can decay."""
        with self._lock:
            ws = self.convergence.setdefault(archetype, [])
            ws.append(int(max(0, width)))
            if len(ws) > _CONVERGENCE_KEEP:
                del ws[:len(ws) - _CONVERGENCE_KEEP]

    def convergence_width(self, archetype: str,
                          default: Optional[int] = None) -> Optional[int]:
        """p90 of the recorded widths for an archetype; ``default`` when
        it was never seen or the p90 decayed to zero."""
        with self._lock:
            ws = self.convergence.get(archetype)
            if not ws:
                return default
            w = int(np.ceil(np.quantile(np.asarray(ws, np.float64), 0.9)))
        return w if w > 0 else default

    # ------------------------------------------------ tuner feedback
    def record_workload(self, signature: str, query, n: int = 1):
        """Record one executed query AST under its plan signature, with
        the batch's count of that signature."""
        with self._lock:
            ring = self.workload.setdefault(signature, [])
            ring.append(query)
            if len(ring) > _WORKLOAD_KEEP:
                del ring[:len(ring) - _WORKLOAD_KEEP]
            self.mix[signature] = self.mix.get(signature, 0) \
                + max(1, int(n))

    def snapshot(self, max_queries: int = 32) -> QBSSnapshot:
        """Export the query-aware state for the background tuner: the
        workload sample interleaves signatures hottest first (cumulative
        execution count), most recent query first within each, up to
        ``max_queries`` ASTs. Every container is a copy, so the snapshot
        stays consistent while serving goes on recording."""
        with self._lock:
            sigs = sorted(self.mix, key=lambda s: -self.mix[s])
            rings = {s: list(reversed(self.workload.get(s, [])))
                     for s in sigs}
            sample: List = []
            i = 0
            while len(sample) < max_queries and any(rings.values()):
                sig = sigs[i % len(sigs)]
                if rings[sig]:
                    sample.append(rings[sig].pop(0))
                i += 1
                if i > max_queries * max(1, len(sigs)):
                    break
            return QBSSnapshot(
                ts=time.time(),
                mix=dict(self.mix),
                convergence={k: list(v)
                             for k, v in self.convergence.items()},
                latency={k: q for k in self.latency
                         if (q := self.latency_quantiles(k)) is not None},
                workload=sample, n_rows=len(self.rows))

    # --------------------------------------------- serving-tier feedback
    def record_latency(self, archetype: str, seconds: float, n: int = 1):
        """Record the per-request service time of one executed
        micro-batch (``n`` requests, each ``seconds`` of compute: batch
        wall time / batch size). Queueing delay is left out, so the
        server's "can it still make its deadline if compute starts now?"
        estimate does not feed back on itself under load."""
        with self._lock:
            ls = self.latency.setdefault(archetype, [])
            ls.extend([float(seconds)] * max(1, int(n)))
            if len(ls) > _LATENCY_KEEP:
                del ls[:len(ls) - _LATENCY_KEEP]

    def latency_quantiles(self, archetype: str) -> Optional[Dict[str, float]]:
        """{p50, p99, n} of the recorded per-request service seconds of a
        signature, or None when it was never served."""
        with self._lock:
            ls = self.latency.get(archetype)
            if not ls:
                return None
            a = np.asarray(ls, np.float64)
            return {"p50": float(np.quantile(a, 0.5)),
                    "p99": float(np.quantile(a, 0.99)), "n": len(ls)}

    # ------------------------------------------------ cost-model feedback
    def record_cost(self, kind: str, features: Sequence[float],
                    seconds: float):
        """Record one executed engine stage's (features, wall seconds)."""
        with self._lock:
            ring = self.cost.setdefault(kind, [])
            ring.append([[float(x) for x in features], float(seconds)])
            self.cost_total += 1
            if len(ring) > _COST_KEEP:
                del ring[:len(ring) - _COST_KEEP]

    def cost_samples(self, kind: str):
        """(X, y) arrays of the kind's recorded samples, or None when it
        was never executed (rows whose feature length differs from the
        newest are stale and ignored)."""
        with self._lock:
            ring = self.cost.get(kind)
            if not ring:
                return None
            f = len(ring[-1][0])
            rows = [(x, s) for x, s in ring if len(x) == f]
            return (np.asarray([x for x, _ in rows], np.float64),
                    np.asarray([s for _, s in rows], np.float64))

    def cost_observed(self, kind: str) -> Optional[float]:
        """Median observed seconds over the kind's ring (None if never
        executed)."""
        with self._lock:
            ring = self.cost.get(kind)
            if not ring:
                return None
            return float(np.median([s for _, s in ring]))

    # ------------------------------------------------------------ consumers
    def extrinsic_score(self, task: Optional[str] = None,
                        time_scale: float = 0.1) -> float:
        """S1 (paper eq. 1): recall/accuracy up, time down, in [0, 1]."""
        rows = [r for r in self.rows if task is None or r.task == task]
        if not rows:
            return 0.0
        rec = float(np.mean([r.recall_at_k for r in rows]))
        acc = float(np.mean([r.accuracy for r in rows]))
        t = float(np.mean([r.query_time_s for r in rows]))
        t_pen = 1.0 / (1.0 + t / time_scale)
        return (rec + acc + t_pen) / 3.0

    def objectives(self, task: Optional[str] = None) -> Dict[str, float]:
        """(time, CBR, accuracy) means for the MORBO optimizer."""
        rows = [r for r in self.rows if task is None or r.task == task]
        if not rows:
            return {"time": float("inf"), "cbr": 1.0, "accuracy": 0.0}
        return {
            "time": float(np.mean([r.query_time_s for r in rows])),
            "cbr": float(np.mean([r.cbr for r in rows])),
            "accuracy": float(np.mean([r.accuracy for r in rows])),
        }

    def per_task(self) -> Dict[str, Dict[str, float]]:
        tasks = sorted({r.task for r in self.rows})
        return {t: self.objectives(t) for t in tasks}

    # ---------------------------------------------------------- persistence
    def save(self, path: str):
        """The reference's ``qbs.json``: at most ``_ROWS_KEEP`` rows and
        every ring but the workload's."""
        with self._lock:
            payload = {"rows": [asdict(r) for r in
                                self.rows[-_ROWS_KEEP:]],
                       "convergence": {k: list(v) for k, v in
                                       self.convergence.items()},
                       "latency": {k: list(v) for k, v in
                                   self.latency.items()},
                       "cost": {k: [list(s) for s in v] for k, v in
                                self.cost.items()},
                       "cost_total": self.cost_total,
                       "rows_keep": _ROWS_KEEP}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "QBSTable":
        """A table from ``save``'s file, or from the legacy format (a bare
        row list); an oversized row log re-enters under the window."""
        t = cls()
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, list):
            rows, conv, lat, cost = data, {}, {}, {}
        else:
            rows, conv = data["rows"], data.get("convergence", {})
            lat = data.get("latency", {})
            cost = data.get("cost", {})
        for r in rows[-_ROWS_KEEP:]:
            t.rows.append(QBSRow(**r))
        t.convergence = {k: [int(w) for w in v] for k, v in conv.items()}
        t.latency = {k: [float(s) for s in v] for k, v in lat.items()}
        t.cost = {k: [[[float(x) for x in f], float(s)] for f, s in v]
                  for k, v in cost.items()}
        # a file without the counter seeds it from the rings' sizes, so
        # the refit cursor starts consistent
        t.cost_total = int(data.get("cost_total",
                                    sum(len(v) for v in t.cost.values()))
                           if isinstance(data, dict) else 0)
        return t


def recall_at_k(result_rows, truth_rows, k: Optional[int] = None) -> float:
    """|result ∩ truth| / |truth| over the first ``k`` truth rows
    (``None``: all of them; ``0``: an empty truth, recalled vacuously)."""
    truth = list(truth_rows) if k is None else list(truth_rows)[:k]
    if not truth:
        return 1.0
    rset = set(int(r) for r in result_rows)
    return sum(1 for t in truth if int(t) in rset) / len(truth)


def accuracy(result_rows, truth_rows) -> float:
    """Jaccard-style query accuracy: |res ∩ truth| / |res ∪ truth|."""
    rset = set(int(r) for r in result_rows)
    tset = set(int(t) for t in truth_rows)
    if not rset and not tset:
        return 1.0
    return len(rset & tset) / max(1, len(rset | tset))
