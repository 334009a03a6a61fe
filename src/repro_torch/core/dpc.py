"""Density Peaks Clustering (Rodriguez & Laio 2014) — the split routine of
the divisive hierarchical index build (paper §6.1.1, Table 7). Port of
``repro/core/dpc.py``.

The exact O(N^2) distance blocks come from ``ops.pairwise_sq_l2`` on
``device``; the density, delta and center decisions stay in host numpy
as in the reference, with the same numpy seeds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


@dataclass
class DPCResult:
    labels: np.ndarray       # (N,) cluster id
    centers: np.ndarray      # (K,) indices of center points
    rho: np.ndarray
    delta: np.ndarray


def _d2(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """Host (M, N) squared distances computed on ``device``."""
    bt = b if isinstance(b, torch.Tensor) else torch.as_tensor(b,
                                                              device=device)
    return ops.pairwise_sq_l2(torch.as_tensor(a, device=device),
                              bt).cpu().numpy()


def dpc(x: np.ndarray, *, dc: Optional[float] = None,
        max_clusters: int = 16, min_clusters: int = 2,
        gamma_gap: float = 3.0, block: int = 4096,
        seed: int = 0, device=None) -> DPCResult:
    """Cluster x (N, D). Returns labels + center indices (see the
    reference for the dc / gamma-gap rules)."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= 2:
        return DPCResult(labels=np.zeros(n, np.int32),
                         centers=np.array([0] if n else [], np.int64),
                         rho=np.ones(n), delta=np.ones(n))
    rng = np.random.default_rng(seed)
    xt = torch.as_tensor(x, device=device)

    # --- dc from a sampled distance quantile
    if dc is None:
        s = x[rng.choice(n, size=min(1024, n), replace=False)]
        d2s = _d2(s, s, device)
        pos = np.sqrt(d2s[d2s > 1e-12])
        dc = float(np.quantile(pos, 0.02)) if len(pos) else 1.0
        dc = max(dc, 1e-6)

    # --- rho (gaussian kernel density) and delta, blocked over rows
    rho = np.empty(n, np.float64)
    for i in range(0, n, block):
        d2 = _d2(x[i:i + block], xt, device)
        rho[i:i + block] = np.exp(-d2 / (dc * dc)).sum(1) - 1.0

    order = np.argsort(-rho, kind="stable")  # descending density
    delta = np.empty(n, np.float64)
    nneigh = np.zeros(n, np.int64)
    for i in range(0, n, block):
        rows = np.arange(i, min(i + block, n))
        d2 = _d2(x[rows], xt, device)
        d = np.sqrt(np.maximum(d2, 0.0))
        higher = rho[None, :] > rho[rows][:, None]
        tie = (rho[None, :] == rho[rows][:, None]) & \
            (np.arange(n)[None, :] < rows[:, None])
        hmask = higher | tie
        dm = np.where(hmask, d, np.inf)
        delta[rows] = dm.min(1)
        nneigh[rows] = dm.argmin(1)
    top = order[0]
    delta[top] = max(delta[np.isfinite(delta)].max(initial=1.0), 1.0)
    nneigh[top] = top

    # --- centers from the gamma gap
    gamma = rho * delta
    gorder = np.argsort(-gamma, kind="stable")
    gs = gamma[gorder]
    kmax = min(max_clusters, n)
    ratios = (gs[:kmax - 1] + 1e-12) / (gs[1:kmax] + 1e-12)
    k = min_clusters
    if len(ratios) > min_clusters - 1:
        cut = int(np.argmax(ratios[min_clusters - 1:kmax])) + min_clusters
        if ratios[cut - 1] >= gamma_gap:
            k = cut
        else:
            k = min(max(min_clusters, 2), kmax)
    centers = gorder[:k]
    if top not in centers:
        # the global density peak must be a center or the nneigh chain of
        # the peak would self-loop unlabeled
        centers = np.concatenate([[top], centers[:-1]])

    # --- assignment: centers claim themselves; others follow nneigh chains
    labels = np.full(n, -1, np.int32)
    labels[centers] = np.arange(k, dtype=np.int32)
    for idx in order:  # descending density => parent already labeled
        if labels[idx] < 0:
            labels[idx] = labels[nneigh[idx]]
    return DPCResult(labels=labels, centers=centers.astype(np.int64),
                     rho=rho, delta=delta)
