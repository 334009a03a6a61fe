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

Ingest (freshness-exact writes): ``append(...)`` lands new rows in a
``DeltaRegion`` (pow2-capacity, NaN-padded buffers) without rebuilding
the index or invalidating cached plans, and every path answers over base
plus delta (``view()``) from the next execution on: the scalar path scans
the delta after its leaf walk, and the engine splices delta tiles into
both beam loops, the V.R planner and the predicate masks
(``HybridEngine.sync_delta``, called by every ``engine()``). ``fold()``
(or the auto-fold past ``auto_fold_ratio``, or the next ``prepare()``)
merges the delta into the learned index through
``index.fold_into_tree`` and bumps ``build_id``; an append only advances
``delta_epoch``, which the oracle's and the view's caches key on. Under
``fold_mode = "background"`` the auto-fold trigger only marks
``fold_due``, which the re-optimization controller (``core/reopt.py``)
consumes by folding beside the serving state.

Persistence (``core/persist.py``): ``save_platform`` writes a
crash-atomic ``gen-XXXX`` snapshot in the reference's format (either
package loads the other's), numbered by ``generation``, which
``prepare`` and ``fold`` advance; a loaded int8 platform hands its
persisted planes (``_quant_cache``) to its engines, which take them
instead of quantizing.

Index generations (online re-optimization): a heavyweight index change
is built BESIDE the serving state and installed in one step.
``build_generation(theta=..., delta_scales=...)`` runs the whole feature
representation and index build with a perturbed transform over the base
plus the delta rows live when it starts, under the last ``prepare()``'s
configuration (``_prepare_cfg``), on ``device``;
``build_fold_generation()`` runs a fold on a copy of the tree (``fold()``
is that generation installed in place). ``swap(gen)`` installs a built generation between micro-batches:
``build_id`` bumps (cached plans and engines invalidate as at
``prepare``), delta rows appended after the build started carry over
into a fresh delta region, and engines prewarmed for the generation
(``Generation.engines``) become the serving engines. The displaced state
is kept as ``_prev_gen``, and ``rollback()`` restores it in one call,
with every row appended since; without one it restores the previous
generation on disk from ``snapshot_dir``. Every path stays
oracle-exact across a swap: only which transform and index serve
changes, never the rows a query answers over. ``objectives_for_morbo``
is the offline (time, CBR, -accuracy) evaluator of Algorithm 1.

Sharded execution: ``engine(shards=S)`` and ``session(shards=S)`` run the
device loop and the V.R tile route over S shards of the tile layout
(``core/engine.py``, ``sharding/partitioning.py``); ``shards=None`` takes
``default_shards`` (persisted in platform.json), ``shards=0`` forces one
device. Each shard count keeps its own cached engine and session.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.index import (BuildReport, ClusterTree, QueryStats,
                                    build_index)
from repro_torch.core.lake import DeltaRegion, MMOTable
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


def _copy_tree(tree: ClusterTree) -> ClusterTree:
    """Deep copy of a ``ClusterTree``: a fold beside the serving state
    mutates bucket ranges, radii and last-mile fits, which the serving
    generation must not see before the swap."""
    return ClusterTree(
        centroid=tree.centroid.copy(), radius=tree.radius.copy(),
        parent=tree.parent.copy(),
        children=[list(c) for c in tree.children],
        is_leaf=tree.is_leaf.copy(),
        bucket_start=tree.bucket_start.copy(),
        bucket_end=tree.bucket_end.copy(),
        lm_a=tree.lm_a.copy(), lm_b=tree.lm_b.copy(),
        depth=tree.depth.copy(),
        access_count=tree.access_count.copy())


@dataclass
class Generation:
    """One complete, self-consistent index and layout state, in one of
    two roles: the output of a beside-build (``build_generation`` /
    ``build_fold_generation``) waiting for ``swap()``, whose
    ``delta_consumed`` says how many live delta rows it baked into its
    base; or the serving state a swap displaced (``kind="serving"``),
    holding the old delta region and ``post_swap_tail`` so ``rollback()``
    restores it without losing rows appended after the swap."""
    gen_id: int
    kind: str                               # "reopt" | "fold" | "serving"
    raw_table: MMOTable
    table: MMOTable
    tree: ClusterTree
    meta: LeafMeta
    enhanced: np.ndarray
    transform: Optional[HyperspaceTransform]
    layout: Dict
    report: Optional[BuildReport]
    delta_consumed: int = 0                 # live delta rows in this base
    base_build_id: int = -1                 # serving build it was built from
    params: Optional[Tuple] = None          # (theta, delta_scales) | None
    engines: Dict = field(default_factory=dict)   # prewarmed HybridEngines
    # rollback bookkeeping (kind == "serving" only)
    delta: Optional[DeltaRegion] = None
    post_swap_tail: int = 0                 # delta rows carried into next gen


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
        # the shard count engine() and session() default to (None: one
        # device); persisted in platform.json and restored by load_platform
        self.default_shards: Optional[int] = None
        # a loaded snapshot's int8 planes (``snapshot_planes`` plus a
        # ``precision`` entry), handed to every engine built; cleared when
        # the layout changes
        self._quant_cache: Optional[Dict] = None
        # the host's calibrated execution cost model (``core/cost.py``),
        # or None: every consumer then keeps its fixed thresholds. Fitted
        # by ``calibrate()``; a host property, so a rebuild keeps it
        self.cost_model = None
        self.build_id = 0  # bumped by every installed state; keys caches
        # ingest: un-folded appends live in the delta region; delta_epoch
        # advances on every append and fold and never resets, so state
        # keyed on it cannot alias
        self.delta: Optional[DeltaRegion] = None
        self.delta_epoch = 0
        self.auto_fold_ratio = 0.5   # fold when delta rows > ratio * base
        # "inline" folds inside append(); "background" only marks
        # ``fold_due`` for a controller to fold beside the serving state
        self.fold_mode: str = "inline"
        self._fold_requested = False
        self._view_cache: Optional[Tuple[Tuple[int, int], MMOTable]] = None
        self._oracle_cache: Dict = {}
        self._engines: Dict = {}
        self._sessions: Dict = {}
        # installed index states, counted monotonically (prepare, fold,
        # swap and rollback advance it); it numbers the snapshots on disk.
        # ``_prev_gen`` is the serving state the last swap displaced (the
        # in-memory rollback); ``snapshot_dir`` (set by save_platform /
        # load_platform) is where rollback() finds the previous generation
        # without one
        self.generation = 0
        self._prev_gen: Optional[Generation] = None
        self.snapshot_dir: Optional[str] = None
        # the last prepare()'s build configuration, which beside-builds
        # reproduce; a loaded platform keeps these defaults, as in the
        # reference (its snapshot does not hold them)
        self._prepare_cfg: Dict = dict(
            columns=None, use_transform=True, use_lpgf=True,
            lpgf_iters=1, delta=0.951, min_leaf=32, max_leaf=4096,
            max_depth=12, dpc_max_clusters=8, dpc_sample=4096)
        self._transform_params: Tuple = (None, None)   # (theta, delta_scales)

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
        """Feature representation + index build + physical re-layout. A
        pending delta region joins ``raw_table`` first, so ``prepare()``
        is the full-rebuild end of append -> union -> fold. The
        configuration is recorded, so later beside-builds
        (``build_generation``) reproduce it; ``prepare`` itself installs
        in place, the blocking end of the rebuild spectrum."""
        if self.delta is not None and self.delta.m:
            self.raw_table = self._merged_raw()
            self.delta = None
            self.delta_epoch += 1
            self._view_cache = None
        self._prepare_cfg = dict(
            columns=columns, use_transform=use_transform,
            use_lpgf=use_lpgf, lpgf_iters=lpgf_iters, delta=delta,
            min_leaf=min_leaf, max_leaf=max_leaf, max_depth=max_depth,
            dpc_max_clusters=dpc_max_clusters, dpc_sample=dpc_sample)
        self._transform_params = (
            None if theta is None else np.asarray(theta, np.float64),
            None if delta_scales is None
            else np.asarray(delta_scales, np.float64))
        st = _build_state(
            self.raw_table, seed=self.seed, device=self.device,
            theta=theta, delta_scales=delta_scales, **self._prepare_cfg)
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
        self._invalidate()

    def _build_meta(self):
        self.meta = build_leaf_meta(self.tree, self.table)

    # ------------------------------------------------------------ ingest
    @property
    def n_base(self) -> int:
        return self.table.n_rows

    @property
    def n_delta(self) -> int:
        return 0 if self.delta is None else self.delta.m

    def append(self, *, numeric: Optional[Dict] = None,
               vector: Optional[Dict] = None,
               raw_uri: Optional[Sequence[str]] = None,
               fold: Optional[bool] = None) -> int:
        """Ingest new rows into the delta region (freshness-exact).

        The rows answer from the very next execution on every path, with
        ids ``n_base + j`` (j = delta position) until a fold re-lays them.
        Columns must cover the table schema exactly; everything is
        validated before any state changes, so a failed append changes
        nothing. Cached plans stay valid (only ``delta_epoch`` advances).
        ``fold``: None = auto (fold once delta rows exceed
        ``auto_fold_ratio`` x base rows; under ``fold_mode =
        "background"`` mark ``fold_due`` instead), False = never, True =
        fold now. Returns the live delta rows after the call."""
        if self.tree is None:
            raise RuntimeError("call prepare() first")
        delta = self.delta
        if delta is None:
            delta = DeltaRegion.for_table(self.table)
        delta.append(dict(numeric or {}), dict(vector or {}), raw_uri)
        self.delta = delta
        self.delta_epoch += 1
        self._view_cache = None
        if fold is True:
            self.fold()
        elif (fold is None and self.auto_fold_ratio
              and self.delta.m > self.auto_fold_ratio * self.table.n_rows):
            if self.fold_mode == "background":
                self._fold_requested = True
            else:
                self.fold()
        return self.n_delta

    @property
    def fold_due(self) -> bool:
        """True when a background fold is wanted: the auto-fold trigger
        fired under ``fold_mode = "background"``, or the delta is past the
        ratio right now in that mode. Cleared by a fold or ``prepare``
        that drains the delta."""
        if self.delta is None or self.delta.m == 0:
            return False
        if self._fold_requested:
            return True
        return bool(self.fold_mode == "background" and self.auto_fold_ratio
                    and self.delta.m
                    > self.auto_fold_ratio * self.table.n_rows)

    def _concat_delta(self, t: MMOTable,
                      row_ids: Optional[np.ndarray] = None,
                      limit: Optional[int] = None) -> MMOTable:
        """``t`` with the live delta rows appended column-wise: the one
        recipe behind ``view()`` (over the physical table) and
        ``_merged_raw`` (over ``raw_table``). ``limit`` keeps the first
        ``limit`` live rows only: a beside-build pins the delta prefix
        live when it started, so rows appended during it stay out of its
        base."""
        d = self.delta
        m = d.m if limit is None else min(limit, d.m)
        uri = None
        if t.raw_uri is not None:
            extra = d.raw_uri if d.raw_uri is not None else [""] * m
            uri = np.concatenate([t.raw_uri,
                                  np.asarray(list(extra)[:m], dtype=object)])
        return MMOTable(
            name=t.name,
            numeric={k: np.concatenate([v, d.live_numeric(k)[:m]])
                     for k, v in t.numeric.items()},
            vector={k: np.concatenate([v, d.live_vector(k)[:m]])
                    for k, v in t.vector.items()},
            raw_uri=uri, embed_model=dict(t.embed_model), row_ids=row_ids)

    def _merged_raw(self, limit: Optional[int] = None) -> MMOTable:
        """``raw_table`` with the (first ``limit``) live delta rows
        appended (raw order)."""
        return self._concat_delta(self.raw_table, limit=limit)

    def _delta_feats(self, m0: Optional[int] = None) -> np.ndarray:
        """The first ``m0`` live delta rows (all by default) through the
        FROZEN feature representation: the transform applied, no re-fit,
        and no LPGF (a build-time movement that shapes layout quality,
        never exactness), in the column order ``prepare()`` used
        (``self.layout``): the features a fold splices into the
        tree."""
        d = self.delta
        m0 = d.m if m0 is None else min(m0, d.m)
        parts = []
        for c in self.layout:
            a = (d.live_vector(c)[:m0] if c in d.vector_dims
                 else d.live_numeric(c)[:m0, None])
            parts.append(a.astype(np.float32))
        feats = np.concatenate(parts, axis=1)
        if self.transform is not None:
            feats = self.transform.apply(feats)
        return feats

    def fold(self) -> int:
        """Merge the delta region into the learned index incrementally:
        ``build_fold_generation`` installed in place. The rows go through
        the frozen feature representation (``_delta_feats``), join their
        nearest leaf (``index.fold_into_tree``: splice, key re-sort,
        last-mile refit, radius widening) and the table is re-laid
        physically; leaf metadata and engine tiles are rebuilt exactly
        from the merged table. Bumps ``build_id`` (cached plans and
        engines invalidate) and ``delta_epoch``. Returns the rows folded
        (0: nothing to do)."""
        gen = self.build_fold_generation()
        if gen is None:
            self._fold_requested = False
            return 0
        self._install_generation(gen)
        self.delta = None
        self.delta_epoch += 1
        self._invalidate()
        return gen.delta_consumed

    # -------------------------------------------------- index generations
    @staticmethod
    def _engine_key(beam: int, tile: int, precision: str,
                    shards: Optional[int] = None) -> Tuple:
        """The cache key of ``engine()`` (``shards``: the effective shard
        count, None on one device, where the key has no shard entry),
        exposed so the re-optimization warm-up can prewarm a
        ``Generation.engines`` entry under the key ``swap()`` serves it
        from."""
        key = (beam, tile, precision)
        return key + (shards,) if shards else key

    def snapshot_generation(self) -> Generation:
        """The current serving state as a ``Generation`` (references, no
        copies: after a swap nothing mutates these objects, so keeping
        them is enough for the in-memory rollback)."""
        return Generation(
            gen_id=self.generation, kind="serving",
            raw_table=self.raw_table, table=self.table, tree=self.tree,
            meta=self.meta, enhanced=self.enhanced,
            transform=self.transform, layout=self.layout,
            report=self.report, base_build_id=self.build_id,
            params=self._transform_params, delta=self.delta)

    def build_generation(self, *,
                         theta: Optional[Sequence[float]] = None,
                         delta_scales: Optional[Sequence[float]] = None
                         ) -> Generation:
        """Full rebuild BESIDE the serving state with a perturbed
        hyperspace transform, on ``device``: the last ``prepare()``'s
        configuration over the base plus the delta rows live now. The
        serving state is not touched; install with ``swap()``."""
        if self.tree is None:
            raise RuntimeError("call prepare() first")
        m0 = self.n_delta
        raw = self._merged_raw(limit=m0) if m0 else self.raw_table
        st = _build_state(raw, seed=self.seed, device=self.device,
                          theta=theta, delta_scales=delta_scales,
                          **self._prepare_cfg)
        return Generation(
            gen_id=self.generation + 1, kind="reopt", raw_table=raw,
            table=st["table"], tree=st["tree"], meta=st["meta"],
            enhanced=st["enhanced"], transform=st["transform"],
            layout=st["layout"], report=st["report"], delta_consumed=m0,
            base_build_id=self.build_id,
            params=(None if theta is None
                    else np.asarray(theta, np.float64),
                    None if delta_scales is None
                    else np.asarray(delta_scales, np.float64)))

    def build_fold_generation(self) -> Optional[Generation]:
        """``fold()`` as a beside-build: the same ``fold_into_tree`` over
        the same frozen-representation features, on a copy of the tree,
        so the serving state answers untouched until ``swap()``. None
        when the delta is empty. Rows appended while it runs stay in the
        delta; ``swap()`` carries them over."""
        from repro_torch.core.index import fold_into_tree
        if self.delta is None or self.delta.m == 0:
            return None
        if self.enhanced is None or self.layout is None:
            raise RuntimeError(
                "a fold needs the prepared state's enhanced features and "
                "column layout")
        m0 = self.delta.m
        tree = _copy_tree(self.tree)
        feats = self._delta_feats(m0)
        perm, bucket_id, bucket_starts = fold_into_tree(
            tree, self.enhanced, feats, device=self.device)
        row_ids = None
        if self.table.row_ids is not None:
            row_ids = np.concatenate([
                self.table.row_ids,
                self.raw_table.n_rows + np.arange(m0)]).astype(np.int64)
        comb = self._concat_delta(self.table, row_ids=row_ids, limit=m0)
        table = comb.apply_permutation(perm, bucket_id, bucket_starts)
        return Generation(
            gen_id=self.generation + 1, kind="fold",
            raw_table=self._merged_raw(limit=m0), table=table, tree=tree,
            meta=build_leaf_meta(tree, table),
            enhanced=np.concatenate([self.enhanced, feats])[perm],
            transform=self.transform, layout=self.layout,
            report=self.report, delta_consumed=m0,
            base_build_id=self.build_id, params=self._transform_params)

    def _install_generation(self, gen: Generation):
        """Point the serving state at ``gen``'s index and layout."""
        self.raw_table = gen.raw_table
        self.table = gen.table
        self.tree = gen.tree
        self.meta = gen.meta
        self.enhanced = gen.enhanced
        self.transform = gen.transform
        self.layout = gen.layout
        self.report = gen.report
        if gen.params is not None:
            self._transform_params = gen.params

    def _invalidate(self):
        """What every installed state (a build, a load, a fold, a swap, a
        rollback) invalidates: views, oracle truths, engines, cached plans
        through ``build_id``, and the displaced generation. A caller that
        replaces the delta region advances ``delta_epoch`` itself."""
        self._fold_requested = False
        self._view_cache = None
        self._oracle_cache.clear()
        self._engines.clear()
        # planes quantized from the previous layout would pass the
        # engine's shape check at the same row count and serve stale
        # bounds
        self._quant_cache = None
        self.build_id += 1
        self.generation += 1
        # the state a swap displaced predates this one: restoring it would
        # drop every row merged since (the reference keeps it)
        self._prev_gen = None

    def swap(self, gen: Generation) -> int:
        """Install a beside-built generation as the serving state in one
        bounded step, between micro-batches.

        Delta rows appended after the build started (positions >=
        ``gen.delta_consumed``) carry over into a fresh delta region; the
        displaced serving state is kept as ``_prev_gen`` for
        ``rollback()``. Cached plans and engines invalidate through the
        ``build_id`` bump; engines prewarmed into ``gen.engines`` (keyed by
        ``_engine_key``) become the serving engines, at most
        ``MAX_ENGINES``, so the first batch after the swap builds none.
        ``cost_model`` stays: it describes the host, not the index.
        Raises ``RuntimeError`` if the serving index changed since the
        build started (a fold or another swap landed first). Returns the
        new generation number."""
        if gen.base_build_id != self.build_id:
            raise RuntimeError(
                f"stale generation: built against build_id "
                f"{gen.base_build_id}, serving is {self.build_id}; "
                f"rebuild against the current state")
        prev = self.snapshot_generation()
        tail: Optional[DeltaRegion] = None
        carried = 0
        if self.delta is not None and self.delta.m > gen.delta_consumed:
            d = self.delta
            sl = slice(gen.delta_consumed, d.m)
            carried = d.m - gen.delta_consumed
            tail = DeltaRegion.for_table(gen.table)
            tail.append(
                {k: d.live_numeric(k)[sl] for k in d.numeric_keys},
                {k: d.live_vector(k)[sl] for k in d.vector_dims},
                None if d.raw_uri is None else d.raw_uri[sl])
        prev.post_swap_tail = carried
        self._install_generation(gen)
        self.delta = tail
        self.delta_epoch += 1
        self._invalidate()
        engines = list(gen.engines.items())[-MAX_ENGINES:]
        self._engines = dict(engines)     # prewarmed, or empty
        gen.gen_id = self.generation
        self._prev_gen = prev
        return self.generation

    def rollback(self) -> int:
        """Restore the serving state before the last ``swap`` in one
        call. The in-memory ``_prev_gen`` is preferred; without one (no
        swap in this process, or already rolled back) and with
        ``snapshot_dir`` set, the previous generation on disk is loaded
        (``persist.rollback_platform``). Rows appended after the swap are
        appended again to the restored delta region, so no write is lost.
        Bumps ``build_id``. Returns the new generation number."""
        prev = self._prev_gen
        if prev is None:
            if self.snapshot_dir is not None:
                from repro_torch.core import persist
                persist.rollback_platform(self.snapshot_dir, into=self)
                return self.generation
            raise RuntimeError("no previous generation retained "
                               "(no swap since startup, or already "
                               "rolled back) and no snapshot_dir set")
        cur = self.delta                     # the post-swap delta region
        self._install_generation(prev)
        self.delta = prev.delta
        # rows appended after the swap sit past the carried tail in the
        # current delta; append them again so the rollback loses nothing
        if cur is not None and cur.m > prev.post_swap_tail:
            sl = slice(prev.post_swap_tail, cur.m)
            if self.delta is None:
                self.delta = DeltaRegion.for_table(self.table)
            self.delta.append(
                {k: cur.live_numeric(k)[sl] for k in cur.numeric_keys},
                {k: cur.live_vector(k)[sl] for k in cur.vector_dims},
                None if cur.raw_uri is None else cur.raw_uri[sl])
        self.delta_epoch += 1
        self._invalidate()
        return self.generation

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
               shards: Optional[int] = None,
               precision: Optional[str] = None):
        """The device-resident batched executor (built lazily, one per
        (beam, tile, shards, precision), invalidated by ``prepare``).
        ``device_loop`` sets the engine's default beam loop only when
        passed explicitly; ``shards`` (None: ``default_shards``; 0: one
        device) the shard count of its device loop and V.R tile route;
        ``precision`` as in ``_resolve_precision``. A sharded engine is
        derived from the cached single-device engine of the same
        configuration when there is one (``HybridEngine.with_shards``).

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
        if shards is None:
            shards = self.default_shards
        shards = shards or None
        key = self._engine_key(beam, tile, prec, shards)
        eng = self._engines.pop(key, None)
        if eng is None:
            twin = self._engines.get(self._engine_key(beam, tile, prec)) \
                if shards else None
            while len(self._engines) >= MAX_ENGINES:
                self._engines.pop(next(iter(self._engines)))
            if twin is not None:
                eng = twin.with_shards(shards)
                eng.device_loop = True if device_loop is None \
                    else device_loop
            else:
                eng = HybridEngine(
                    self.tree, self.table, self.meta, beam=beam, tile=tile,
                    device_loop=True if device_loop is None else device_loop,
                    device=self.device, precision=prec,
                    quant_cache=self._quant_cache, shards=shards)
        elif device_loop is not None:
            eng.device_loop = device_loop
        self._engines[key] = eng      # (re-)inserted last: LRU order
        # refreshed on every call: a cached engine may predate a
        # calibration, and its V.R route reads the model per batch
        eng.cost_model = self.cost_model
        # union un-folded appends into the device state (a no-op while
        # the write epoch is unchanged)
        eng.sync_delta(self.delta, self.delta_epoch)
        return eng

    def session(self, *, device_loop: bool = True, beam: int = 16,
                tile: int = 128, shards: Optional[int] = None,
                precision: Optional[str] = None):
        """The MOAPI v2 entry point: a ``Session`` over this platform
        (cached per configuration, the effective shard count and precision
        included). ``session().plan(queries)`` gives an ``ExecutablePlan``
        with ``execute()`` / ``explain()``. ``shards``: None takes
        ``default_shards``, 0 forces one device; a session whose shard
        count nobody pinned (no argument, no default) lets a calibrated
        cost model choose among the shard counts it has fitted
        (``auto_topology``), which is part of the cache key too."""
        from repro_torch.core.planner import Session
        eff = self.default_shards if shards is None else shards
        eff = eff or None
        prec = self._resolve_precision(precision)
        auto = shards is None and self.default_shards is None
        key = (device_loop, beam, tile, eff, prec, auto)
        if key not in self._sessions:
            self._sessions[key] = Session(
                self, device_loop=device_loop, beam=beam, tile=tile,
                shards=0 if eff is None else eff, precision=prec,
                auto_topology=auto)
        return self._sessions[key]

    def calibrate(self, *, shard_counts=None, batch: int = 16,
                  repeats: int = 2, seed: int = 0):
        """Fit (or refresh) this host's execution cost model from a
        synthetic sweep through both beam loops and the device loop over
        each of ``shard_counts`` (``cost.calibrate_platform``) and install
        it as ``cost_model``: from then on ``Session.plan`` picks the loop
        and shard count and the engine the V.R route by predicted cost,
        and observed stage times refit it online."""
        from repro_torch.core.cost import calibrate_platform
        return calibrate_platform(self, shard_counts=shard_counts,
                                  batch=batch, repeats=repeats, seed=seed)

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
        """Exact boolean mask over physical rows for N.E / N.R / V.R. Live
        delta rows occupy the tail ``n_base..n_base+m-1`` and are scanned
        directly (the delta has no leaf metadata)."""
        nb = self.table.n_rows
        mask = np.zeros(nb + self.n_delta, bool)
        if self.n_delta:
            stats.rows_scanned += self.n_delta
            if isinstance(q, Q.NE):
                col = self.delta.live_numeric(q.attr)
                mask[nb:] = np.abs(col - q.value) <= q.tol
            elif isinstance(q, Q.NR):
                col = self.delta.live_numeric(q.attr)
                mask[nb:] = (col >= q.lo) & (col <= q.hi)
            else:  # VR
                col = self.delta.live_vector(q.attr)
                mask[nb:] = ((col - q.vec()) ** 2).sum(1) <= q.radius ** 2
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
        visit order. Live delta rows merge in after the leaf scan by the
        same stable sort, so base rows stay ahead of delta rows on exact
        ties."""
        m = self.meta
        qv = q.vec()
        col = self.table.vector[q.attr]
        nb = self.table.n_rows
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
        if self.n_delta:
            dcol = self.delta.live_vector(q.attr)
            d2 = ((dcol - qv) ** 2).sum(1)
            if row_mask is not None:
                d2 = np.where(row_mask[nb:], d2, np.inf)
            stats.rows_scanned += self.n_delta
            alld = np.concatenate([best_d, np.sqrt(np.maximum(d2, 0))])
            alli = np.concatenate([best_i, nb + np.arange(self.n_delta)])
            sel = np.argsort(alld, kind="stable")[:q.k]
            keep = np.isfinite(alld[sel])
            best_d, best_i = alld[sel], np.where(keep, alli[sel], -1)
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
        n = self.table.n_rows + self.n_delta
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

    def objectives_for_morbo(self, workload: Sequence[Q.Query]):
        """The (time, CBR, -accuracy) evaluator over ``params`` =
        (theta, delta_scales) for the offline MORBO transform search
        (paper Algorithm 1): each call re-prepares this platform in place
        (transform on, LPGF off) and runs the workload on the scalar
        path."""
        def f(params: np.ndarray) -> np.ndarray:
            k = len(params) // 2
            theta, dscale = params[:k], params[k:]
            self.prepare(use_transform=True, use_lpgf=False,
                         theta=theta, delta_scales=dscale)
            times, cbrs, accs = [], [], []
            for q in workload:
                rows, st = self.execute(q, record=False)
                truth = self.oracle(q)
                times.append(st.time_s)
                cbrs.append(st.cbr)
                accs.append(accuracy(rows, truth))
            return np.array([np.mean(times), np.mean(cbrs),
                             -np.mean(accs)])
        return f

    # ------------------------------------------------------------- oracle
    def view(self) -> MMOTable:
        """The queryable table: the physical base rows plus the live
        delta rows at ids ``n_base..n_base+m-1``, which every path and
        the oracle answer over. The base table itself while the delta is
        empty; cached per (build, write epoch)."""
        if self.delta is None or self.delta.m == 0:
            return self.table
        key = (self.build_id, self.delta_epoch)
        if self._view_cache is not None and self._view_cache[0] == key:
            return self._view_cache[1]
        row_ids = None
        if self.table.row_ids is not None:
            # delta rows take the raw ids they will hold once folded
            row_ids = np.concatenate([
                self.table.row_ids,
                self.raw_table.n_rows + np.arange(self.delta.m)]
            ).astype(np.int64)
        v = self._concat_delta(self.table, row_ids=row_ids)
        self._view_cache = (key, v)
        return v

    def oracle(self, query: Q.Query) -> np.ndarray:
        """Brute-force truth over the queryable view (base + live delta),
        cached per (query, build, write epoch)."""
        key = (repr(query), self.build_id, self.delta_epoch)
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
      ``enhanced`` (optional) the permuted enhanced features (N, F)
      ``layout/<col>`` (optional) each prepared column's (start, end)
        slice of the enhanced features (``fold()`` needs both)
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
    # copies: fold() and Algorithm 3 update the tree in place, which
    # must not reach the caller's arrays
    tree = ClusterTree(
        centroid=np.array(arrays["tree/centroid"]),
        radius=np.array(arrays["tree/radius"]),
        parent=np.array(arrays["tree/parent"]),
        children=[[int(c) for c in cidx[ptr[i]:ptr[i + 1]]]
                  for i in range(len(ptr) - 1)],
        is_leaf=np.array(arrays["tree/is_leaf"], bool),
        bucket_start=np.array(arrays["tree/bucket_start"]),
        bucket_end=np.array(arrays["tree/bucket_end"]),
        lm_a=np.array(arrays["tree/lm_a"]),
        lm_b=np.array(arrays["tree/lm_b"]),
        depth=np.array(arrays["tree/depth"]))
    meta = LeafMeta(vec_centroid=cols("meta/vec_centroid/"),
                    vec_radius=cols("meta/vec_radius/"),
                    num_lo=cols("meta/num_lo/"), num_hi=cols("meta/num_hi/"))
    transform = None
    if "transform/r" in arrays:
        transform = HyperspaceTransform(
            r=np.asarray(arrays["transform/r"]),
            s=np.asarray(arrays["transform/s"]),
            mean=np.asarray(arrays["transform/mean"]))
    layout = None
    spans = cols("layout/")
    if spans:     # the prepared column order is the slices' order
        layout = {c: (int(v[0]), int(v[1]))
                  for c, v in sorted(spans.items(), key=lambda e: e[1][0])}
    enhanced = (np.asarray(arrays["enhanced"], np.float32)
                if "enhanced" in arrays else None)
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
                          transform=transform, layout=layout,
                          enhanced=enhanced, meta=meta))
    return p
