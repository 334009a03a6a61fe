"""MQRLD platform facade — port of ``repro/core/platform.py`` for the
batched hybrid query on one device.

Pipeline: ``MQRLD(table, device=...).prepare()`` runs the feature
representation (hyperspace transform on the host, LPGF on the device)
and the learned-index build, re-lays the table physically and computes
the per-leaf metadata; ``session().plan(batch).execute()`` then answers
a batch of rich hybrid queries through the device-resident
``HybridEngine``. Every answer equals the brute-force ``oracle``.

``state_from_numpy`` installs a prepared state given as plain numpy
arrays (for example the JAX reference's), so both packages can serve one
identical index.

The KNN scan precision ("fp32", "bf16", "int8") is chosen per engine
and session: an explicit ``precision`` argument, else the
``MQRLD_PRECISION`` environment variable, else ``default_precision``.
Every precision returns the same rows.

``execute(query)`` is the paper-faithful scalar path: a host-side
walk per query over the leaf metadata, the path that records QBS rows
(sampled at ``qbs_sample``), per-query ``QueryStats`` and Algorithm 3's
access counts, and the planner's fallback for queries the engine cannot
plan. It is host numpy, as in the reference, so its rows, stats and
counts are the reference's. ``optimize_index(workload)`` runs Algorithm
3 on those counts. ``calibrate()`` fits the host's ``cost_model``
(``core/cost.py``), which every engine and session of the platform then
reads.

Not ported yet: append/fold and the delta region (ROADMAP queue 1 item
3), persistence (item 4), index generations and the optimizer's
objectives (item 7), and sharding (item 8).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.index import (BuildReport, ClusterTree, QueryStats,
                                    build_index)
from repro_torch.core.lake import MMOTable
from repro_torch.core.lpgf import lpgf
from repro_torch.core.qbs import QBSTable, accuracy, recall_at_k
from repro_torch.core.reorder import reorder_siblings
from repro_torch.core.transform import (HyperspaceTransform, init_transform,
                                        perturb)
from repro_torch.utils.quant import PRECISIONS

# engines kept by ``MQRLD.engine()``, as in the reference
MAX_ENGINES = 4


@dataclass
class LeafMeta:
    """Per-leaf exact-space pruning metadata."""
    vec_centroid: Dict[str, np.ndarray]   # attr -> (L, d_attr)
    vec_radius: Dict[str, np.ndarray]     # attr -> (L,)
    num_lo: Dict[str, np.ndarray]         # attr -> (L,)
    num_hi: Dict[str, np.ndarray]


def build_leaf_meta(tree: ClusterTree, table: MMOTable) -> LeafMeta:
    """Exact original-space pruning metadata for every leaf of ``tree``
    over the PERMUTED ``table`` (bucket ranges index it directly)."""
    leaves = tree.leaf_ids
    vc, vr, nlo, nhi = {}, {}, {}, {}
    for attr, col in table.vector.items():
        cs, rs = [], []
        for lid in leaves:
            s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
            pts = col[s:e]
            c = pts.mean(axis=0) if e > s else np.zeros(col.shape[1])
            cs.append(c)
            rs.append(float(np.sqrt(
                np.max(((pts - c) ** 2).sum(1), initial=0.0))))
        vc[attr] = np.stack(cs).astype(np.float32)
        vr[attr] = np.asarray(rs, np.float32)
    for attr, col in table.numeric.items():
        los, his = [], []
        for lid in leaves:
            s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
            los.append(float(col[s:e].min(initial=np.inf)))
            his.append(float(col[s:e].max(initial=-np.inf)))
        nlo[attr] = np.asarray(los, np.float32)
        nhi[attr] = np.asarray(his, np.float32)
    return LeafMeta(vec_centroid=vc, vec_radius=vr, num_lo=nlo, num_hi=nhi)


def _bucket_layout(tree: ClusterTree, n: int):
    """(bucket_id (n,), bucket_starts (L+1,)) of the physical layout."""
    leaves = tree.leaf_ids
    bucket_id = np.zeros(n, np.int32)
    for b, lid in enumerate(leaves):
        s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
        bucket_id[s:e] = b
    bucket_starts = np.concatenate(
        [tree.bucket_start[leaves], [n]]).astype(np.int32)
    return bucket_id, bucket_starts


def _build_state(raw_table: MMOTable, *, seed: int, device,
                 columns: Optional[List[str]] = None,
                 use_transform: bool = True, use_lpgf: bool = True,
                 lpgf_iters: int = 1, delta: float = 0.951,
                 min_leaf: int = 32, max_leaf: int = 4096,
                 max_depth: int = 12, dpc_max_clusters: int = 8,
                 dpc_sample: int = 4096,
                 theta: Optional[Sequence[float]] = None,
                 delta_scales: Optional[Sequence[float]] = None) -> Dict:
    """The feature-representation + index-build pipeline as a pure
    function of an input table: transform init (+ optional perturbation),
    LPGF movement, learned-index build, physical re-layout, leaf
    metadata."""
    d, layout = raw_table.concat_features(columns)
    feats = d
    transform = None
    if use_transform:
        transform = init_transform(d)
        if theta is not None or delta_scales is not None:
            transform = perturb(
                transform,
                theta if theta is not None else [],
                delta_scales if delta_scales is not None else [])
        feats = transform.apply(d)
    if use_lpgf:
        feats = lpgf(feats, iters=lpgf_iters, seed=seed, device=device)
    tree, perm, report = build_index(
        feats, delta=delta, min_leaf=min_leaf, max_leaf=max_leaf,
        max_depth=max_depth, dpc_max_clusters=dpc_max_clusters,
        dpc_sample=dpc_sample, seed=seed, device=device)
    bucket_id, bucket_starts = _bucket_layout(tree, len(perm))
    table = raw_table.apply_permutation(perm, bucket_id, bucket_starts)
    return dict(table=table, tree=tree, report=report, transform=transform,
                enhanced=feats[perm], layout=layout,
                meta=build_leaf_meta(tree, table))


class MQRLD:
    """The platform. One instance per MMO table, on one ``device``
    (``None`` = the CUDA card; raises when there is none)."""

    def __init__(self, table: MMOTable, *, qbs_sample: float = 1.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.raw_table = table.validate()
        self.table: Optional[MMOTable] = None
        self.qbs = QBSTable(sample_rate=qbs_sample, seed=seed)
        self.tree: Optional[ClusterTree] = None
        self.report: Optional[BuildReport] = None
        self.transform: Optional[HyperspaceTransform] = None
        self.meta: Optional[LeafMeta] = None
        self.enhanced: Optional[np.ndarray] = None
        self.layout: Optional[Dict] = None
        self.seed = seed
        # mixed-precision serving default: engine()/session() calls that
        # do not pass ``precision`` use it, after the MQRLD_PRECISION
        # environment override
        self.default_precision: str = "fp32"
        # the host's calibrated execution cost model (``core/cost.py``),
        # or None: every consumer then keeps its fixed thresholds. Fitted
        # by ``calibrate()``; a host property, so a rebuild keeps it
        self.cost_model = None
        self.build_id = 0  # bumped by every installed state; keys caches
        self._oracle_cache: Dict = {}
        self._engines: Dict = {}
        self._sessions: Dict = {}

    # ------------------------------------------------------------ build
    def prepare(self, columns: Optional[List[str]] = None, *,
                use_transform: bool = True, use_lpgf: bool = True,
                lpgf_iters: int = 1, delta: float = 0.951,
                min_leaf: int = 32, max_leaf: int = 4096,
                max_depth: int = 12, dpc_max_clusters: int = 8,
                theta: Optional[Sequence[float]] = None,
                dpc_sample: int = 4096,
                delta_scales: Optional[Sequence[float]] = None
                ) -> BuildReport:
        """Feature representation + index build + physical re-layout."""
        st = _build_state(
            self.raw_table, seed=self.seed, device=self.device,
            columns=columns, use_transform=use_transform,
            use_lpgf=use_lpgf, lpgf_iters=lpgf_iters, delta=delta,
            min_leaf=min_leaf, max_leaf=max_leaf, max_depth=max_depth,
            dpc_max_clusters=dpc_max_clusters, dpc_sample=dpc_sample,
            theta=theta, delta_scales=delta_scales)
        self._install_state(st)
        return st["report"]

    def _install_state(self, st: Dict):
        """Install a built state and invalidate everything derived from
        the old one (engines, cached plans through ``build_id``, oracle
        truths)."""
        self.table = st["table"]
        self.tree = st["tree"]
        self.report = st["report"]
        self.transform = st["transform"]
        self.layout = st["layout"]
        self.enhanced = st["enhanced"]
        self.meta = st["meta"]
        self._oracle_cache.clear()
        self._engines.clear()
        self.build_id += 1

    # ------------------------------------------------------- batched engine
    def _resolve_precision(self, precision: Optional[str]) -> str:
        """Scan precision: explicit argument > MQRLD_PRECISION > the
        platform's ``default_precision``. Explicit wins over the
        environment, so a caller that pins fp32 stays fp32."""
        p = precision or os.environ.get("MQRLD_PRECISION") \
            or self.default_precision
        if p not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {p!r}")
        return p

    def engine(self, *, beam: int = 16, tile: int = 128,
               device_loop: Optional[bool] = None,
               precision: Optional[str] = None):
        """The device-resident batched executor (built lazily, one per
        (beam, tile, precision), invalidated by ``prepare``).
        ``device_loop`` sets the engine's default beam loop only when
        passed explicitly; ``precision`` as in ``_resolve_precision``.

        At most ``MAX_ENGINES`` are kept, least recently used first out
        (the reference's bound): each engine holds device copies of the
        whole table's tiles, and a precision's planes besides, so a
        process sweeping configurations must not keep one per
        configuration it ever touched. An evicted engine is derived
        state; asking for it again rebuilds it."""
        if self.tree is None:
            raise RuntimeError("call prepare() first")
        from repro_torch.core.engine import HybridEngine
        prec = self._resolve_precision(precision)
        key = (beam, tile, prec)
        eng = self._engines.pop(key, None)
        if eng is None:
            while len(self._engines) >= MAX_ENGINES:
                self._engines.pop(next(iter(self._engines)))
            eng = HybridEngine(
                self.tree, self.table, self.meta, beam=beam, tile=tile,
                device_loop=True if device_loop is None else device_loop,
                device=self.device, precision=prec)
        elif device_loop is not None:
            eng.device_loop = device_loop
        self._engines[key] = eng      # (re-)inserted last: LRU order
        # refreshed on every call: a cached engine may predate a
        # calibration, and its V.R route reads the model per batch
        eng.cost_model = self.cost_model
        return eng

    def session(self, *, device_loop: bool = True, beam: int = 16,
                tile: int = 128, precision: Optional[str] = None):
        """The MOAPI v2 entry point: a ``Session`` over this platform
        (cached per configuration, precision included).
        ``session().plan(queries)`` gives an ``ExecutablePlan`` with
        ``execute()`` / ``explain()``."""
        from repro_torch.core.planner import Session
        prec = self._resolve_precision(precision)
        key = (device_loop, beam, tile, prec)
        if key not in self._sessions:
            self._sessions[key] = Session(self, device_loop=device_loop,
                                          beam=beam, tile=tile,
                                          precision=prec)
        return self._sessions[key]

    def calibrate(self, *, batch: int = 16, repeats: int = 2,
                  seed: int = 0):
        """Fit (or refresh) this host's execution cost model from a
        synthetic sweep through both beam loops
        (``cost.calibrate_platform``) and install it as ``cost_model``:
        from then on ``Session.plan`` picks the loop and the engine the
        V.R route by predicted cost, and observed stage times refit it
        online."""
        from repro_torch.core.cost import calibrate_platform
        return calibrate_platform(self, batch=batch, repeats=repeats,
                                  seed=seed)

    def execute_batch(self, queries: Sequence[Q.Query], *,
                      device_loop: bool = True):
        """v1 shim: ``session().plan(queries).execute()``."""
        return self.session().plan(queries,
                                   device_loop=device_loop).execute()

    # ------------------------------------------------------------ leaves
    def _leaf_rows(self, leaf_pos: int) -> np.ndarray:
        lid = self.tree.leaf_ids[leaf_pos]
        return np.arange(int(self.tree.bucket_start[lid]),
                         int(self.tree.bucket_end[lid]))

    def _count_leaf(self, leaf_pos: int):
        """Algorithm 3 statistics: the leaf and its ancestors were
        scanned to reach it."""
        node = int(self.tree.leaf_ids[leaf_pos])
        while node >= 0:
            self.tree.access_count[node] += 1
            node = int(self.tree.parent[node])

    # ------------------------------------------------------- scalar path
    def _predicate_leaves(self, q) -> np.ndarray:
        """Positions (into leaf_ids) of leaves that may contain matches."""
        m = self.meta
        if isinstance(q, Q.NE):
            return np.nonzero((m.num_lo[q.attr] <= q.value + q.tol)
                              & (m.num_hi[q.attr] >= q.value - q.tol))[0]
        if isinstance(q, Q.NR):
            return np.nonzero((m.num_lo[q.attr] <= q.hi)
                              & (m.num_hi[q.attr] >= q.lo))[0]
        if isinstance(q, Q.VR):
            qv = q.vec()
            d = np.sqrt(np.maximum(((m.vec_centroid[q.attr] - qv) ** 2)
                                   .sum(1), 0))
            return np.nonzero(d - m.vec_radius[q.attr] <= q.radius)[0]
        raise TypeError(q)

    def _mask_from_predicate(self, q, stats: QueryStats) -> np.ndarray:
        """Exact boolean mask over physical rows for N.E / N.R / V.R."""
        mask = np.zeros(self.table.n_rows, bool)
        for lp in self._predicate_leaves(q):
            stats.touch(lp)
            self._count_leaf(lp)
            rows = self._leaf_rows(lp)
            stats.rows_scanned += len(rows)
            if isinstance(q, Q.NE):
                col = self.table.numeric[q.attr][rows]
                mask[rows] = np.abs(col - q.value) <= q.tol
            elif isinstance(q, Q.NR):
                col = self.table.numeric[q.attr][rows]
                mask[rows] = (col >= q.lo) & (col <= q.hi)
            else:  # VR
                col = self.table.vector[q.attr][rows]
                d2 = ((col - q.vec()) ** 2).sum(1)
                mask[rows] = d2 <= q.radius ** 2
        return mask

    def _knn(self, q: Q.VK, stats: QueryStats,
             row_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Exact per-attribute KNN by leaf lower-bound ranking: leaves in
        bound order until the bound passes the k-th distance, merged
        carry first with a stable sort, so equal distances keep the
        visit order."""
        m = self.meta
        qv = q.vec()
        col = self.table.vector[q.attr]
        dc = np.sqrt(np.maximum(((m.vec_centroid[q.attr] - qv) ** 2)
                                .sum(1), 0))
        lb = np.maximum(dc - m.vec_radius[q.attr], 0.0)
        order = np.argsort(lb, kind="stable")
        best_d = np.full(q.k, np.inf)
        best_i = np.full(q.k, -1, np.int64)
        for pos in order:
            if lb[pos] > best_d[-1]:
                break
            stats.touch(pos)
            self._count_leaf(pos)
            rows = self._leaf_rows(pos)
            stats.rows_scanned += len(rows)
            d2 = ((col[rows] - qv) ** 2).sum(1)
            if row_mask is not None:
                d2 = np.where(row_mask[rows], d2, np.inf)
            d = np.sqrt(np.maximum(d2, 0))
            alld = np.concatenate([best_d, d])
            alli = np.concatenate([best_i, rows])
            sel = np.argsort(alld, kind="stable")[:q.k]
            best_d, best_i = alld[sel], alli[sel]
        return best_i[best_i >= 0]

    def execute(self, query: Q.Query, *, task: str = "",
                record: bool = True) -> Tuple[np.ndarray, QueryStats]:
        """Execute a rich hybrid query through the learned index on the
        host (the scalar path). ``record`` samples a QBS row against the
        oracle's truth and records the query's workload signature."""
        if self.tree is None:
            raise RuntimeError("call prepare() first")
        t0 = time.time()
        stats = QueryStats()
        rows = self._exec(query, stats, row_mask=None)
        stats.time_s = time.time() - t0
        stats.cbr = stats.buckets_touched / max(1, len(self.tree.leaf_ids))
        if record:
            truth = self.oracle(query)
            self.qbs.maybe_record(
                statement=repr(query), object_set=self.table.name,
                attributes=Q.query_attrs(query), types=Q.query_types(query),
                recall_at_k=recall_at_k(rows, truth),
                cbr=stats.cbr, query_time_s=stats.time_s,
                accuracy=accuracy(rows, truth), task=task)
            self.qbs.record_workload(Q.signature(Q.normalize(query)),
                                     query)
        return rows, stats

    def _exec(self, q, stats: QueryStats,
              row_mask: Optional[np.ndarray]) -> np.ndarray:
        n = self.table.n_rows
        if isinstance(q, (Q.NE, Q.NR, Q.VR)):
            mask = self._mask_from_predicate(q, stats)
            if row_mask is not None:
                mask &= row_mask
            return np.nonzero(mask)[0]
        if isinstance(q, Q.VK):
            return self._knn(q, stats, row_mask)
        if isinstance(q, Q.And):
            preds = [p for p in q.parts if not isinstance(p, Q.VK)]
            vks = [p for p in q.parts if isinstance(p, Q.VK)]
            mask = row_mask
            for p in preds:
                rows = self._exec(p, stats, mask)
                pm = np.zeros(n, bool)
                pm[rows] = True
                mask = pm if mask is None else (mask & pm)
            if not vks:
                return np.nonzero(mask)[0] if mask is not None else \
                    np.arange(n)
            result = None
            for vk in vks:
                rows = self._knn(vk, stats, mask)
                rm = np.zeros(n, bool)
                rm[rows] = True
                result = rm if result is None else (result & rm)
            return np.nonzero(result)[0]
        if isinstance(q, Q.Or):
            out = np.zeros(n, bool)
            for p in q.parts:
                out[self._exec(p, stats, row_mask)] = True
            return np.nonzero(out)[0]
        raise TypeError(q)

    # -------------------------------------------------- query-aware tuning
    def optimize_index(self, workload: Sequence[Q.Query],
                       tie_break: bool = False) -> int:
        """Algorithm 3: run the workload on the scalar path to collect
        access counts, then reorder sibling lists. Returns the number of
        child lists changed."""
        self.tree.access_count[:] = 0
        for q in workload:
            self.execute(q, record=False)

        cost_fn = None
        if tie_break:
            def cost_fn():
                total = 0
                for q in workload:
                    _, st = self.execute(q, record=False)
                    total += st.nodes_scanned
                return total
        return reorder_siblings(self.tree, cost_fn)

    # ------------------------------------------------------------- oracle
    def view(self) -> MMOTable:
        """The queryable table (the delta region is not ported yet, so
        it is the physical base table)."""
        return self.table

    def oracle(self, query: Q.Query) -> np.ndarray:
        """Brute-force truth over the queryable view, cached per (query,
        build)."""
        key = (repr(query), self.build_id)
        if key not in self._oracle_cache:
            self._oracle_cache[key] = Q.execute_bruteforce(self.view(),
                                                           query)
        return self._oracle_cache[key]


def state_from_numpy(arrays: Dict[str, np.ndarray], *, seed: int = 0,
                     device=None) -> MQRLD:
    """A platform serving a prepared state given as plain numpy arrays —
    the counterpart of carrying a model's weights across. Keys:

      ``raw/num/<col>``, ``raw/vec/<col>``      raw table columns
      ``table/num/<col>``, ``table/vec/<col>``  permuted table columns
      ``table/bucket_id``, ``table/bucket_starts``, ``table/row_ids``
      ``tree/<field>`` for every ``ClusterTree`` array field, with the
        sibling lists as ``tree/children_ptr`` (M+1,) and
        ``tree/children_idx`` (CSR)
      ``meta/<vec_centroid|vec_radius|num_lo|num_hi>/<col>``
      ``transform/r``, ``transform/s``, ``transform/mean`` (optional)
      ``name`` (optional, a 0-d string array)
    """
    def cols(prefix: str) -> Dict[str, np.ndarray]:
        return {k[len(prefix):]: np.asarray(v) for k, v in arrays.items()
                if k.startswith(prefix)}

    name = str(arrays["name"]) if "name" in arrays else "table"
    raw = MMOTable(name, numeric=cols("raw/num/"), vector=cols("raw/vec/"))
    table = MMOTable(
        name, numeric=cols("table/num/"), vector=cols("table/vec/"),
        bucket_id=np.asarray(arrays["table/bucket_id"], np.int32),
        bucket_starts=np.asarray(arrays["table/bucket_starts"], np.int32),
        row_ids=np.asarray(arrays["table/row_ids"]))
    ptr = np.asarray(arrays["tree/children_ptr"])
    cidx = np.asarray(arrays["tree/children_idx"])
    tree = ClusterTree(
        centroid=np.asarray(arrays["tree/centroid"]),
        radius=np.asarray(arrays["tree/radius"]),
        parent=np.asarray(arrays["tree/parent"]),
        children=[[int(c) for c in cidx[ptr[i]:ptr[i + 1]]]
                  for i in range(len(ptr) - 1)],
        is_leaf=np.asarray(arrays["tree/is_leaf"], bool),
        bucket_start=np.asarray(arrays["tree/bucket_start"]),
        bucket_end=np.asarray(arrays["tree/bucket_end"]),
        lm_a=np.asarray(arrays["tree/lm_a"]),
        lm_b=np.asarray(arrays["tree/lm_b"]),
        depth=np.asarray(arrays["tree/depth"]))
    meta = LeafMeta(vec_centroid=cols("meta/vec_centroid/"),
                    vec_radius=cols("meta/vec_radius/"),
                    num_lo=cols("meta/num_lo/"), num_hi=cols("meta/num_hi/"))
    transform = None
    if "transform/r" in arrays:
        transform = HyperspaceTransform(
            r=np.asarray(arrays["transform/r"]),
            s=np.asarray(arrays["transform/s"]),
            mean=np.asarray(arrays["transform/mean"]))
    p = MQRLD(raw, seed=seed, device=device)
    leaves = tree.leaf_ids
    report = BuildReport(
        n_nodes=tree.n_nodes, n_leaves=len(leaves),
        max_depth=tree.max_depth(),
        avg_bucket=float(np.mean(tree.bucket_end[leaves]
                                 - tree.bucket_start[leaves])),
        build_s=0.0, lm_hit_ratio=float("nan"),
        index_bytes=tree.size_bytes())
    p._install_state(dict(table=table, tree=tree, report=report,
                          transform=transform, layout=None, enhanced=None,
                          meta=meta))
    return p
