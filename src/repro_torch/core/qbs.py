"""Query Behavior Statistic (QBS) table — the query-aware mechanism
(paper §4.3, Table 3). Port of ``repro/core/qbs.py`` (numpy only).

This slice carries the rings that a planned batch records into and the
planner reads back: per-archetype convergence widths (the beam seeds of
``Session.plan``), per-stage cost samples and per-signature workload
samples. The per-query row log (the scalar executor's), service
latencies (the server's), persistence and the tuner snapshot come with
the slices that write or read them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


_CONVERGENCE_KEEP = 64  # recent widths kept per archetype (ring buffer)
_WORKLOAD_KEEP = 16     # recent executed query ASTs kept per signature
_COST_KEEP = 256        # recent (features, seconds) samples per stage kind


class QBSTable:
    def __init__(self):
        self.convergence: Dict[str, List[int]] = {}
        self.workload: Dict[str, List] = {}
        self.mix: Dict[str, int] = {}
        self.cost: Dict[str, List] = {}
        self.cost_total: int = 0
        # every ring append/trim and every multi-ring reader runs under
        # this lock, so recording can never interleave a trim with an
        # append or lose a ``cost_total`` increment
        self._lock = threading.RLock()

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

    def cost_observed(self, kind: str) -> Optional[float]:
        """Median observed seconds over the kind's ring (None if never
        executed)."""
        with self._lock:
            ring = self.cost.get(kind)
            if not ring:
                return None
            return float(np.median([s for _, s in ring]))
