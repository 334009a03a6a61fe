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

Not in this slice: the scalar executor (``execute``), append/fold and
the delta region, index generations, persistence, calibration and
sharding.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.index import BuildReport, ClusterTree, build_index
from repro_torch.core.lake import MMOTable
from repro_torch.core.lpgf import lpgf
from repro_torch.core.qbs import QBSTable
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

    def __init__(self, table: MMOTable, *, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.raw_table = table.validate()
        self.table: Optional[MMOTable] = None
        self.qbs = QBSTable()
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

    def execute_batch(self, queries: Sequence[Q.Query], *,
                      device_loop: bool = True):
        """v1 shim: ``session().plan(queries).execute()``."""
        return self.session().plan(queries,
                                   device_loop=device_loop).execute()

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
