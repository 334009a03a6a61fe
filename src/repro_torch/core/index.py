"""High-dimensional learned index (paper §6). Port of
``repro/core/index.py``: the build (Algorithm 2), the incremental fold
that merges ingested rows into the tree (``fold_into_tree``) and the two
executors.

Build = divisive hierarchical clustering: DPC splits, a training-based
stop rule (a linear CDF over distance-to-centroid keys must predict
in-bucket positions with hit ratio >= delta), and a cluster tree of
{centroid, radius, ordered children | last-mile model}, stored as
struct-of-arrays whose leaf buckets are contiguous row ranges of the
permuted table. The tree logic is host numpy with the reference's seeds,
so both packages build the same tree from the same features wherever
their fp32 distances agree; the distance blocks run on ``device``.

Queries run in two executors that return the same rows:

  * ``HostExecutor`` — the paper-faithful traversal in sibling order
    with C/R pruning and model-seeded last-mile windows; it counts node
    scans and bucket touches (CBR, Algorithm 3's input). Host numpy, as
    in the reference, so rows, ``QueryStats`` and ``access_count`` are
    the reference's bit for bit.
  * ``BatchedExecutor`` — lower-bound ranking over every leaf tile with
    the beam doubling of ``engine.batched_knn``, whose rounds launch the
    ``topk_l2_masked`` kernel on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.dpc import dpc
from repro_torch.core.lpgf import lpgf
from repro_torch.core.engine import (_RERANK_EXTRA, _U32, EngineStats,
                                     LeafGeometry, batched_knn,
                                     bucket_tiles, rerank_exact, tile_data,
                                     widen_exact)
from repro_torch.kernels import ops


@dataclass
class ClusterTree:
    centroid: np.ndarray      # (M, d)
    radius: np.ndarray        # (M,)
    parent: np.ndarray        # (M,)
    children: List[List[int]]  # sibling order = search order (Algorithm 3)
    is_leaf: np.ndarray       # (M,) bool
    bucket_start: np.ndarray  # (M,) leaf row ranges (else -1)
    bucket_end: np.ndarray
    lm_a: np.ndarray          # (M,) last-mile slope (leaves)
    lm_b: np.ndarray          # (M,) last-mile intercept
    depth: np.ndarray         # (M,)
    access_count: np.ndarray = field(default=None)  # Algorithm 3 statistics

    def __post_init__(self):
        if self.access_count is None:
            self.access_count = np.zeros(len(self.radius), np.int64)

    @property
    def n_nodes(self) -> int:
        return len(self.radius)

    @property
    def leaf_ids(self) -> np.ndarray:
        return np.nonzero(self.is_leaf)[0]

    def max_depth(self) -> int:
        return int(self.depth.max(initial=0))

    def size_bytes(self) -> int:
        arrs = [self.centroid, self.radius, self.parent, self.is_leaf,
                self.bucket_start, self.bucket_end, self.lm_a, self.lm_b,
                self.depth]
        child = sum(len(c) for c in self.children) * 8
        return int(sum(a.nbytes for a in arrs) + child)


@dataclass
class QueryStats:
    nodes_scanned: int = 0
    buckets_touched: int = 0        # unique buckets per query
    rows_scanned: int = 0
    time_s: float = 0.0
    cbr: float = 0.0
    _bucket_ids: set = field(default_factory=set)

    def touch(self, bucket_id: int):
        self._bucket_ids.add(int(bucket_id))
        self.buckets_touched = len(self._bucket_ids)


@dataclass
class BuildReport:
    n_nodes: int
    n_leaves: int
    max_depth: int
    avg_bucket: float
    build_s: float
    lm_hit_ratio: float       # mean last-mile hit ratio across leaves
    index_bytes: int


def _fit_last_mile(keys_sorted: np.ndarray) -> Tuple[float, float]:
    """Least-squares fit F(k) = a*k + b with F(k)*m ~ position."""
    m = len(keys_sorted)
    if m <= 1:
        return 0.0, 0.5
    target = (np.arange(m) + 0.5) / m
    k = keys_sorted.astype(np.float64)
    var = k.var()
    if var < 1e-18:
        return 0.0, float(target.mean())
    a = float(np.cov(k, target, bias=True)[0, 1] / var)
    b = float(target.mean() - a * k.mean())
    return a, b


def _hit_ratio(keys_sorted: np.ndarray, a: float, b: float,
               tol: int) -> float:
    m = len(keys_sorted)
    if m == 0:
        return 1.0
    pred = np.clip(np.round((a * keys_sorted + b) * m - 0.5), 0, m - 1)
    return float(np.mean(np.abs(pred - np.arange(m)) <= tol))


def build_index(features: np.ndarray, *, delta: float = 0.951,
                hit_tol: int = 8, min_leaf: int = 32, max_leaf: int = 4096,
                max_depth: int = 12, split_lpgf: bool = False,
                dpc_max_clusters: int = 8, dpc_sample: int = 4096,
                seed: int = 0, device=None
                ) -> Tuple[ClusterTree, np.ndarray, BuildReport]:
    """Build the cluster tree over features (already representation-
    enhanced). Returns (tree, perm, report): ``perm`` maps new physical
    row order -> original row index. ``split_lpgf``: each node of more
    than ``min_leaf`` rows is split by DPC on its points moved by one
    LPGF step (``lpgf(pts, iters=1)`` on ``device``), as the
    reference's option does; the tree's centroids and keys stay the
    unmoved points'."""
    t0 = time.time()
    device = resolve_device(device)
    x = np.asarray(features, np.float32)
    n = len(x)
    idx_all = np.arange(n)

    nodes: List[dict] = []
    order_rows: List[np.ndarray] = []
    cursor = 0
    hit_ratios: List[float] = []

    def new_node(parent: int, depth: int) -> int:
        nodes.append(dict(parent=parent, depth=depth, children=[],
                          centroid=None, radius=0.0, is_leaf=False,
                          start=-1, end=-1, a=0.0, b=0.0))
        return len(nodes) - 1

    root = new_node(-1, 0)
    stack: List[Tuple[int, np.ndarray]] = [(root, idx_all)]

    rng = np.random.default_rng(seed)
    while stack:
        node_id, rows = stack.pop()
        pts = x[rows]
        c = pts.mean(axis=0)
        nodes[node_id]["centroid"] = c
        keys = np.sqrt(np.maximum(
            ((pts - c[None]) ** 2).sum(1), 0.0)).astype(np.float32)
        nodes[node_id]["radius"] = float(keys.max(initial=0.0))

        srt = np.argsort(keys, kind="stable")
        a, b = _fit_last_mile(keys[srt])
        hr = _hit_ratio(keys[srt], a, b, hit_tol)

        stop = (len(rows) <= min_leaf
                or nodes[node_id]["depth"] >= max_depth
                or (hr >= delta and len(rows) <= max_leaf))
        if not stop:
            # split via DPC (optionally LPGF-enhanced coordinates)
            sub = pts
            if split_lpgf and len(rows) > min_leaf:
                sub = lpgf(pts, iters=1, device=device)
            if len(rows) > dpc_sample:
                # sample-fit DPC centers, then assign all rows to nearest
                sel = rng.choice(len(rows), dpc_sample, replace=False)
                res = dpc(sub[sel], max_clusters=dpc_max_clusters,
                          seed=seed, device=device)
                cent = np.stack([sub[sel][res.labels == l].mean(0)
                                 for l in np.unique(res.labels)])
                d2 = ops.pairwise_sq_l2(
                    torch.as_tensor(sub, device=device),
                    torch.as_tensor(cent, device=device)).cpu().numpy()
                labels = d2.argmin(1).astype(np.int32)
            else:
                labels = dpc(sub, max_clusters=dpc_max_clusters,
                             seed=seed, device=device).labels
            uniq = np.unique(labels)
            if len(uniq) >= 2:
                subclusters = []
                for l in uniq:
                    sel = rows[labels == l]
                    if len(sel):
                        subclusters.append(sel)
                # sibling order: child centroid distance to parent centroid
                cents = [x[s].mean(0) for s in subclusters]
                dists = [float(np.linalg.norm(cc - c)) for cc in cents]
                order = np.argsort(dists, kind="stable")
                for oi in order:
                    child = new_node(node_id, nodes[node_id]["depth"] + 1)
                    nodes[node_id]["children"].append(child)
                    stack.append((child, subclusters[oi]))
                continue
            # DPC failed to split -> fall through to leaf

        # leaf: physical layout = rows sorted by key
        nodes[node_id]["is_leaf"] = True
        nodes[node_id]["a"], nodes[node_id]["b"] = a, b
        hit_ratios.append(hr)
        nodes[node_id]["start"] = cursor
        nodes[node_id]["end"] = cursor + len(rows)
        order_rows.append(rows[srt])
        cursor += len(rows)

    perm = np.concatenate(order_rows) if order_rows else np.array([], np.int64)
    tree = ClusterTree(
        centroid=np.stack([nd["centroid"] for nd in nodes]),
        radius=np.array([nd["radius"] for nd in nodes], np.float32),
        parent=np.array([nd["parent"] for nd in nodes], np.int32),
        children=[list(nd["children"]) for nd in nodes],
        is_leaf=np.array([nd["is_leaf"] for nd in nodes], bool),
        bucket_start=np.array([nd["start"] for nd in nodes], np.int64),
        bucket_end=np.array([nd["end"] for nd in nodes], np.int64),
        lm_a=np.array([nd["a"] for nd in nodes], np.float32),
        lm_b=np.array([nd["b"] for nd in nodes], np.float32),
        depth=np.array([nd["depth"] for nd in nodes], np.int32),
    )
    leaves = tree.leaf_ids
    report = BuildReport(
        n_nodes=len(nodes), n_leaves=len(leaves), max_depth=tree.max_depth(),
        avg_bucket=float(np.mean(tree.bucket_end[leaves]
                                 - tree.bucket_start[leaves])),
        build_s=time.time() - t0,
        lm_hit_ratio=float(np.mean(hit_ratios)) if hit_ratios else 1.0,
        index_bytes=tree.size_bytes())
    return tree, perm, report


# ---------------------------------------------------------------------------
# Incremental fold (the ingest merge path)
# ---------------------------------------------------------------------------
def fold_into_tree(tree: ClusterTree, enhanced: np.ndarray,
                   delta_enh: np.ndarray, *, device=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge delta rows into an existing tree's leaf buckets in place.

    Each delta row goes to its nearest leaf centroid in the enhanced
    space (one ``pairwise_sq_l2`` pass on ``device``), leaf and ancestor
    radii widen to cover it, and each leaf that gained rows is re-sorted
    by distance to its centroid (stable) with its last-mile fit refitted.
    The walk, the splice and the fits are the reference's host numpy, so
    the folded tree is its bit for bit wherever the nearest-leaf pass
    agrees. Exactness of every query path never depends on the
    assignment: leaf metadata and engine tiles are rebuilt from the
    merged table.

    ``enhanced`` is the PERMUTED base feature matrix (tree bucket ranges
    index it), ``delta_enh`` the delta rows in the same space. Mutates
    ``tree`` (bucket ranges, radii, last-mile fits) and returns ``(perm,
    bucket_id, bucket_starts)`` over the combined [base-physical; delta]
    row order, ready for ``MMOTable.apply_permutation``."""
    dev = resolve_device(device)
    nb, m = len(enhanced), len(delta_enh)
    leaves = tree.leaf_ids
    cen = tree.centroid[leaves].astype(np.float32)
    d2 = ops.pairwise_sq_l2(
        torch.as_tensor(np.asarray(delta_enh, np.float32), device=dev),
        torch.as_tensor(cen, device=dev))
    assign = d2.argmin(dim=1).cpu().numpy()       # leaf position per row
    del d2
    # widen ancestor balls so C/R pruning stays conservative
    for j in range(m):
        node = int(leaves[assign[j]])
        x = delta_enh[j]
        while node >= 0:
            dist = float(np.linalg.norm(x - tree.centroid[node]))
            if dist > tree.radius[node]:
                tree.radius[node] = dist
            node = int(tree.parent[node])
    comb = np.concatenate([np.asarray(enhanced, np.float32),
                           np.asarray(delta_enh, np.float32)])
    # splice per leaf, walking leaves in their current physical order
    order = np.argsort(tree.bucket_start[leaves], kind="stable")
    segs: List[np.ndarray] = []
    cursor = 0
    for pos in order:
        lid = int(leaves[pos])
        s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
        extra = np.nonzero(assign == pos)[0]
        rows = np.concatenate([np.arange(s, e, dtype=np.int64),
                               nb + extra.astype(np.int64)])
        if len(extra) and len(rows):
            keys = np.sqrt(np.maximum(
                ((comb[rows] - tree.centroid[lid][None]) ** 2).sum(1),
                0.0)).astype(np.float32)
            srt = np.argsort(keys, kind="stable")
            rows = rows[srt]
            a, b = _fit_last_mile(keys[srt])
            tree.lm_a[lid], tree.lm_b[lid] = a, b
        tree.bucket_start[lid] = cursor
        tree.bucket_end[lid] = cursor + len(rows)
        segs.append(rows)
        cursor += len(rows)
    perm = np.concatenate(segs) if segs else np.array([], np.int64)
    bucket_id = np.zeros(len(perm), np.int32)
    for b, lid in enumerate(leaves):
        s, e = int(tree.bucket_start[lid]), int(tree.bucket_end[lid])
        bucket_id[s:e] = b
    bucket_starts = np.concatenate(
        [tree.bucket_start[leaves], [len(perm)]]).astype(np.int32)
    return perm, bucket_id, bucket_starts


# ---------------------------------------------------------------------------
# Host executor (paper-faithful traversal)
# ---------------------------------------------------------------------------
class HostExecutor:
    """Sibling-order traversal with C/R pruning + last-mile bucket scans.

    ``data`` must be the PERMUTED feature matrix (tree bucket ranges index
    it directly); ``keys[i]`` = distance of row i to its leaf centroid.
    """

    def __init__(self, tree: ClusterTree, data: np.ndarray):
        self.tree = tree
        self.data = np.asarray(data, np.float32)
        self.keys = self._row_keys()

    def _row_keys(self) -> np.ndarray:
        keys = np.zeros(len(self.data), np.float32)
        for lid in self.tree.leaf_ids:
            s, e = (int(self.tree.bucket_start[lid]),
                    int(self.tree.bucket_end[lid]))
            c = self.tree.centroid[lid]
            keys[s:e] = np.sqrt(
                np.maximum(((self.data[s:e] - c) ** 2).sum(1), 0))
        return keys

    def _leaf_window(self, lid: int, key_lo: float, key_hi: float
                     ) -> Tuple[int, int]:
        """Last-mile search: the linear CDF model predicts the position of
        the query key; the window doubles outward until the sorted keys
        bracket [key_lo, key_hi] (paper §6.1.1)."""
        s, e = int(self.tree.bucket_start[lid]), int(self.tree.bucket_end[lid])
        m = e - s
        if m == 0:
            return s, s
        ks = self.keys[s:e]
        a, b = float(self.tree.lm_a[lid]), float(self.tree.lm_b[lid])
        # model-seeded exponential expansion, then exact tighten
        pos_lo = int(np.clip(round((a * key_lo + b) * m - 0.5), 0, m - 1))
        pos_hi = int(np.clip(round((a * key_hi + b) * m - 0.5), 0, m - 1))
        w = 8
        lo = pos_lo
        while lo > 0 and ks[lo] >= key_lo:
            lo = max(0, lo - w)
            w *= 2
        w = 8
        hi = pos_hi + 1
        while hi < m and ks[hi - 1] <= key_hi:
            hi = min(m, hi + w)
            w *= 2
        lo_b = lo + int(np.searchsorted(ks[lo:hi], key_lo, side="left"))
        hi_b = lo + int(np.searchsorted(ks[lo:hi], key_hi, side="right"))
        return s + lo_b, s + hi_b

    def knn(self, q: np.ndarray, k: int,
            row_mask: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, QueryStats]:
        t0 = time.time()
        tree = self.tree
        stats = QueryStats()
        q = np.asarray(q, np.float32)
        best_d = np.full(k, np.inf)
        best_i = np.full(k, -1, np.int64)

        def push(cands: np.ndarray):
            nonlocal best_d, best_i
            if not len(cands):
                return
            d2 = ((self.data[cands] - q) ** 2).sum(1)
            if row_mask is not None:
                d2 = np.where(row_mask[cands], d2, np.inf)
            d = np.sqrt(np.maximum(d2, 0))
            # carried best first, then a stable sort: equal distances
            # keep the visit order
            alld = np.concatenate([best_d, d])
            alli = np.concatenate([best_i, cands])
            sel = np.argsort(alld, kind="stable")[:k]
            best_d, best_i = alld[sel], alli[sel]

        def visit(node: int):
            stats.nodes_scanned += 1
            tree.access_count[node] += 1
            cq = float(np.linalg.norm(q - tree.centroid[node]))
            lb = max(0.0, cq - float(tree.radius[node]))
            if lb > best_d[-1]:
                return
            if tree.is_leaf[node]:
                stats.touch(node)
                dk = best_d[-1]
                if np.isfinite(dk):
                    lo, hi = self._leaf_window(node, cq - dk, cq + dk)
                else:
                    lo, hi = (int(tree.bucket_start[node]),
                              int(tree.bucket_end[node]))
                stats.rows_scanned += hi - lo
                push(np.arange(lo, hi))
                return
            for ch in tree.children[node]:  # sibling order (Algorithm 3)
                visit(ch)

        visit(0)
        stats.time_s = time.time() - t0
        stats.cbr = stats.buckets_touched / max(1, len(tree.leaf_ids))
        valid = best_i >= 0
        return best_i[valid], stats

    def range_query(self, q: np.ndarray, radius: float,
                    row_mask: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, QueryStats]:
        t0 = time.time()
        tree = self.tree
        stats = QueryStats()
        q = np.asarray(q, np.float32)
        out: List[np.ndarray] = []

        def visit(node: int):
            stats.nodes_scanned += 1
            tree.access_count[node] += 1
            cq = float(np.linalg.norm(q - tree.centroid[node]))
            if cq - float(tree.radius[node]) > radius:
                return
            if tree.is_leaf[node]:
                stats.touch(node)
                lo, hi = self._leaf_window(node, cq - radius, cq + radius)
                stats.rows_scanned += hi - lo
                cands = np.arange(lo, hi)
                d2 = ((self.data[cands] - q) ** 2).sum(1)
                m = d2 <= radius * radius
                if row_mask is not None:
                    m &= row_mask[cands]
                out.append(cands[m])
                return
            for ch in tree.children[node]:
                visit(ch)

        visit(0)
        stats.time_s = time.time() - t0
        stats.cbr = stats.buckets_touched / max(1, len(tree.leaf_ids))
        rows = np.concatenate(out) if out else np.array([], np.int64)
        return rows, stats


# ---------------------------------------------------------------------------
# Batched executor (the card's path)
# ---------------------------------------------------------------------------
class BatchedExecutor:
    """Vectorized leaf-ranked KNN: lower bounds over every leaf tile and
    beam doubling against the bound, over ``engine.batched_knn``, whose
    rounds launch the ``topk_l2_masked`` kernel on the card (its plain
    version on the CPU). Tiles carry the tree's leaf balls, as in the
    reference.

    Exactness: the fp32 expansion the kernel ranks by reorders near-tied
    neighbours at high dimension, so the scan keeps ``_RERANK_EXTRA``
    candidates past the stopping rank k (rounds, tiles and rows scanned
    stay those of a k scan) and each query's candidates go through the
    engine's certified exact re-rank (``engine.rerank_exact``); a query
    whose re-rank is not proven takes the widening pass
    (``engine.widen_exact``). Rows are the brute-force oracle's, exactly
    equal distances by row id; distances are L2 (not squared), the exact
    ones of the returned rows."""

    def __init__(self, tree: ClusterTree, data: np.ndarray, *, device=None,
                 tile: int = 128):
        self.device = dev = resolve_device(device)
        self.tree = tree
        self.data = np.asarray(data, np.float32)
        leaves = tree.leaf_ids
        rows, cap, leaf_of_tile = bucket_tiles(tree.bucket_start[leaves],
                                               tree.bucket_end[leaves], tile)
        self.bucket_cap = cap
        cen = np.asarray(tree.centroid[leaves][leaf_of_tile], np.float32)
        rad = np.asarray(tree.radius[leaves][leaf_of_tile], np.float32)
        self.geom = LeafGeometry(
            centroid=torch.as_tensor(cen, device=dev),
            radius=torch.as_tensor(rad, device=dev),
            bucket_rows=torch.as_tensor(rows, dtype=torch.int64, device=dev),
            cap=cap,
            cen_max2=float((cen.astype(np.float64) ** 2).sum(1)
                           .max(initial=0)),
            rad_max=float(rad.max(initial=0)))
        tiles = tile_data(self.data, rows)
        self._data_tiles = torch.as_tensor(tiles, device=dev)
        self._data_dev = torch.as_tensor(self.data, device=dev)
        # max |row|^2, padded against its fp32 rounding (the re-rank's
        # error scale, as the engine keeps it)
        self._max2 = float((tiles ** 2).sum(-1).max(initial=0)) * (
            1 + (tiles.shape[-1] + 2) * _U32)
        self.exact_fallbacks = 0   # queries of the last knn() widened

    def knn(self, qs: np.ndarray, k: int, beam: int = 8
            ) -> Tuple[np.ndarray, np.ndarray, QueryStats]:
        """qs: (Q, d) -> (dists (Q, k), rows (Q, k), stats); -1 / inf
        pad slots when fewer than k rows exist. Exact."""
        es = EngineStats()
        qv = np.asarray(qs, np.float32)
        q_t = torch.as_tensor(qv, device=self.device)
        next_lb: list = []
        dist, rows = batched_knn(self.geom, self._data_tiles, q_t,
                                 k + _RERANK_EXTRA, beam=beam, k_stop=k,
                                 stats=es, next_lb_out=next_lb)
        res: List[Optional[np.ndarray]] = []
        fails = []
        for i in range(len(qv)):
            r, ok, t_k = rerank_exact(self.data, qv[i], dist[i], rows[i],
                                      next_lb[0][i], k, self._max2,
                                      self.geom)
            res.append(r)
            if not ok:
                fails.append((i, k, t_k))
        if fails:
            for (i, _, _), r in zip(fails, widen_exact(
                    self.data, self._data_dev, q_t, qv, None, fails,
                    self._max2)):
                res[i] = r
        out_d = np.full((len(qv), k), np.inf, np.float32)
        out_r = np.full((len(qv), k), -1, np.int64)
        for i, r in enumerate(res):
            d2 = np.sum((self.data[r] - qv[i][None, :]) ** 2, axis=1)
            out_d[i, :len(r)] = np.sqrt(np.maximum(d2, 0))
            out_r[i, :len(r)] = r
        self.exact_fallbacks = len(fails)
        stats = QueryStats()
        stats.buckets_touched = es.knn_buckets
        stats.rows_scanned = es.rows_scanned
        stats.time_s = es.time_s
        # buckets_touched counts TILES: normalize by the tile count so
        # cbr <= 1
        stats.cbr = stats.buckets_touched / max(
            1, len(qv) * self.geom.n_leaves)
        return out_d, out_r, stats
