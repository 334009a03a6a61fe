"""MOAPI — the rich-hybrid query interface (paper §4.2).

Four basic query types over an MMOTable:
  N.E  — numeric equal            N.R — numeric range
  V.K  — vector k-nearest          V.R — vector range (radius)

A *rich hybrid query* is any ∩/∪ combination tree of basic queries.
Semantics (result = set of row indices):
  * N.E / N.R / V.R are predicates (exact sets).
  * V.K returns the k nearest rows *among the candidate set implied by the
    sibling predicates under an intersection* (post-filter semantics — this
    is what "top-k products under $20" means); under a union it is the
    global top-k. ``normalize`` makes that implicit rule explicit: it
    stamps every V.K node's ``postfilter`` attribute (None = not yet
    normalized) so downstream planning never re-derives it from context.

Execution (MOAPI v2): the query AST is *declarative* — callers hand trees
to ``MQRLD.session().plan(queries)`` (core/planner.py), which canonicalizes
them here (``normalize``: flatten VK-free nested And / nested Or, dedupe
parts where idempotence holds, annotate V.K postfilter), derives a stable
``signature`` (the *archetype*: shape + types + attrs + k, constants
elided) used as the plan-cache key, and compiles an ``ExecutablePlan``.
``execute_bruteforce`` below is the exact oracle used by tests/benchmarks
(its V.K rows are ordered by exact distance, exactly equal distances by
row id);
the scalar learned-index walk lives in ``MQRLD.execute``
(core/platform.py), the batched device path in core/engine.py.

Normalization is semantics-preserving for EVERY tree, including the
scalar executor's order-dependent corner (a V.K inside a combiner that
is itself a sibling of other And parts): flattening stops at And
children that contain a V.K, single-part collapse applies to VK-free
parts only (set-valued, so row order is unaffected), and And-part
dedupe skips VK-containing combiner children (their second evaluation
sees a different threaded mask and is NOT idempotent).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.lake import MMOTable


# ---------------------------------------------------------------------------
# Query AST
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NE:
    attr: str
    value: float
    tol: float = 1e-6


@dataclass(frozen=True)
class NR:
    attr: str
    lo: float
    hi: float


@dataclass(frozen=True)
class VK:
    attr: str
    query: tuple   # query vector (hashable: tuple of floats)
    k: int
    # post-filter semantics, made explicit by ``normalize``: True = top-k
    # among the candidate set of sibling predicates (direct child of an
    # And that has predicate parts), False = global top-k (top level,
    # under Or, or an And with no predicate parts), None = unnormalized.
    postfilter: Optional[bool] = None

    @staticmethod
    def of(attr, vec, k):
        return VK(attr, tuple(np.asarray(vec, np.float32).tolist()), int(k))

    def vec(self):
        return np.asarray(self.query, np.float32)


@dataclass(frozen=True)
class VR:
    attr: str
    query: tuple
    radius: float

    @staticmethod
    def of(attr, vec, r):
        return VR(attr, tuple(np.asarray(vec, np.float32).tolist()), float(r))

    def vec(self):
        return np.asarray(self.query, np.float32)


@dataclass(frozen=True)
class And:
    parts: tuple  # of query nodes

    @staticmethod
    def of(*parts):
        return And(tuple(parts))


@dataclass(frozen=True)
class Or:
    parts: tuple

    @staticmethod
    def of(*parts):
        return Or(tuple(parts))


Query = Union[NE, NR, VK, VR, And, Or]


def basic_queries(q: Query) -> List[Query]:
    if isinstance(q, (And, Or)):
        out = []
        for p in q.parts:
            out.extend(basic_queries(p))
        return out
    return [q]


def query_types(q: Query) -> List[str]:
    return [type(b).__name__ for b in basic_queries(q)]


def query_attrs(q: Query) -> List[str]:
    return sorted({b.attr for b in basic_queries(q)})


# ---------------------------------------------------------------------------
# Canonicalization (MOAPI v2 planner front end)
# ---------------------------------------------------------------------------
def _contains_vk(q: Query) -> bool:
    return any(isinstance(b, VK) for b in basic_queries(q))


def normalize(q: Query) -> Query:
    """Canonical, semantics-preserving form of a rich hybrid query.

    * nested combiners are flattened into their parent (And-in-And only
      when the child is VK-free — an inner And(pred, VK) scopes its V.K
      to the inner candidate set and must keep its own node; Or-in-Or
      always, unions are associative for every node type);
    * duplicate parts are removed where evaluation is idempotent: all Or
      parts, and And parts that are predicates or direct V.K children
      (VK-containing combiner children of an And see a threaded mask in
      the scalar executor, so their duplicates are kept);
    * single-part combiners collapse when the part is VK-free (VK parts
      keep their wrapper: And(VK)/Or(VK) return ascending row-id sets
      while a top-level VK is distance-ordered);
    * every V.K gets its ``postfilter`` attribute stamped (True iff it is
      a direct child of an And that has at least one non-VK part).

    Idempotent: ``normalize(normalize(q)) == normalize(q)``.
    """
    if isinstance(q, (NE, NR, VR)):
        return q
    if isinstance(q, VK):
        # bare / under-Or context: global top-k
        return q if q.postfilter is False \
            else VK(q.attr, q.query, q.k, False)
    if isinstance(q, (And, Or)):
        is_and = isinstance(q, And)
        parts: List[Query] = []
        for p in q.parts:
            p = normalize(p)
            if is_and and isinstance(p, And) and not _contains_vk(p):
                parts.extend(p.parts)
            elif not is_and and isinstance(p, Or):
                parts.extend(p.parts)
            else:
                parts.append(p)
        seen, ded = set(), []
        for p in parts:
            dedupable = (not is_and or isinstance(p, (NE, NR, VR, VK))
                         or not _contains_vk(p))
            if dedupable and p in seen:
                continue
            seen.add(p)
            ded.append(p)
        if len(ded) == 1 and not _contains_vk(ded[0]):
            return ded[0]
        if is_and and any(not isinstance(p, VK) for p in ded):
            ded = [VK(p.attr, p.query, p.k, True) if isinstance(p, VK)
                   and p.postfilter is not True else p for p in ded]
        return And(tuple(ded)) if is_and else Or(tuple(ded))
    raise TypeError(q)


def signature(q: Query) -> str:
    """Stable archetype signature of a (normalized) query: tree shape,
    node types, attributes, k, and V.K postfilter context — constants
    (values, bounds, query vectors, radii) elided. Two queries with equal
    signatures share grouping structure, job layout, and execution path,
    which is what the Session plan cache keys on."""
    if isinstance(q, NE):
        return f"NE:{q.attr}"
    if isinstance(q, NR):
        return f"NR:{q.attr}"
    if isinstance(q, VR):
        return f"VR:{q.attr}"
    if isinstance(q, VK):
        ctx = {True: "post", False: "global", None: "?"}[q.postfilter]
        return f"VK:{q.attr}:k{q.k}:{ctx}"
    if isinstance(q, (And, Or)):
        name = "And" if isinstance(q, And) else "Or"
        return f"{name}({','.join(signature(p) for p in q.parts)})"
    raise TypeError(q)


# ---------------------------------------------------------------------------
# Exact oracle execution
# ---------------------------------------------------------------------------
def _predicate_mask(table: MMOTable, q: Query) -> Optional[np.ndarray]:
    """Boolean mask for predicate nodes; None when subtree contains V.K."""
    n = table.n_rows
    if isinstance(q, NE):
        return np.abs(table.numeric[q.attr] - q.value) <= q.tol
    if isinstance(q, NR):
        a = table.numeric[q.attr]
        return (a >= q.lo) & (a <= q.hi)
    if isinstance(q, VR):
        x = table.vector[q.attr]
        return _sq_dists(x, np.arange(n), q.vec()) <= q.radius ** 2
    if isinstance(q, VK):
        return None
    masks = [_predicate_mask(table, p) for p in q.parts]
    if any(m is None for m in masks):
        return None
    if isinstance(q, And):
        out = np.ones(n, bool)
        for m in masks:
            out &= m
        return out
    out = np.zeros(n, bool)
    for m in masks:
        out |= m
    return out


def _sq_dists(x: np.ndarray, rows: np.ndarray, v: np.ndarray,
              block: int = 2048) -> np.ndarray:
    """``np.sum((x[rows] - v) ** 2, axis=1)`` in blocks of rows: each
    row's sum is the same, bit for bit, and no temporary the size of the
    table is made, so threads sharing the host's memory bus scale."""
    out = []
    for i in range(0, len(rows), block):
        t = x[rows[i:i + block]] - v[None, :]
        t **= 2
        out.append(np.sum(t, axis=1))
    if not out:
        return np.zeros(0, np.result_type(x.dtype, v.dtype))
    return np.concatenate(out)


def _knn_rows(table: MMOTable, q: VK, candidates: np.ndarray) -> np.ndarray:
    x = table.vector[q.attr]
    if candidates.dtype == bool:
        cand_idx = np.nonzero(candidates)[0]
    else:
        cand_idx = candidates
    if len(cand_idx) == 0:
        return cand_idx
    d2 = _sq_dists(x, cand_idx, q.vec())
    k = min(q.k, len(cand_idx))
    # exactly equal distances order by row id (the reference leaves them
    # in argpartition's order, which is arbitrary): every row within the
    # k-th distance, then the first k by (distance, row)
    kth = d2[np.argpartition(d2, k - 1)[k - 1]]
    sel = np.nonzero(d2 <= kth)[0]
    sel = sel[np.lexsort((cand_idx[sel], d2[sel]))[:k]]
    return cand_idx[sel]


def execute_bruteforce(table: MMOTable, q: Query) -> np.ndarray:
    """Exact result rows (sorted unless a VK imposes distance order)."""
    n = table.n_rows
    if isinstance(q, (NE, NR, VR)):
        return np.nonzero(_predicate_mask(table, q))[0]
    if isinstance(q, VK):
        return _knn_rows(table, q, np.ones(n, bool))
    if isinstance(q, And):
        vks = [p for p in q.parts if isinstance(p, VK)]
        preds = [p for p in q.parts if not isinstance(p, VK)]
        mask = np.ones(n, bool)
        for p in preds:
            m = _predicate_mask(table, p)
            if m is None:  # nested combiner containing VK
                rows = execute_bruteforce(table, p)
                m = np.zeros(n, bool)
                m[rows] = True
            mask &= m
        if not vks:
            return np.nonzero(mask)[0]
        result = None
        for vk in vks:  # top-k among surviving candidates
            rows = _knn_rows(table, vk, mask)
            rmask = np.zeros(n, bool)
            rmask[rows] = True
            result = rmask if result is None else (result & rmask)
        return np.nonzero(result)[0]
    if isinstance(q, Or):
        out = np.zeros(n, bool)
        for p in q.parts:
            out[execute_bruteforce(table, p)] = True
        return np.nonzero(out)[0]
    raise TypeError(q)
