"""High-dimensional learned index (paper §6): the build (Algorithm 2).
Port of ``repro/core/index.py``; the host executor, the batched executor
and the incremental fold come with later slices.

Build = divisive hierarchical clustering: DPC splits, a training-based
stop rule (a linear CDF over distance-to-centroid keys must predict
in-bucket positions with hit ratio >= delta), and a cluster tree of
{centroid, radius, ordered children | last-mile model}, stored as
struct-of-arrays whose leaf buckets are contiguous row ranges of the
permuted table. The tree logic is host numpy with the reference's seeds,
so both packages build the same tree from the same features wherever
their fp32 distances agree; the distance blocks run on ``device``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.dpc import dpc
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
                max_depth: int = 12, dpc_max_clusters: int = 8,
                dpc_sample: int = 4096, seed: int = 0, device=None
                ) -> Tuple[ClusterTree, np.ndarray, BuildReport]:
    """Build the cluster tree over features (already representation-
    enhanced). Returns (tree, perm, report): ``perm`` maps new physical
    row order -> original row index. (The reference's ``split_lpgf``
    option, off by default and unused by the platform, is not ported.)"""
    t0 = time.time()
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
            sub = pts
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
