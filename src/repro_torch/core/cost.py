"""Calibrated per-host execution cost model for the planner's path
choices. Port of ``repro/core/cost.py`` for one device.

The planner picks the KNN beam loop (host doubling loop or device
loop) and the engine picks the V.R route (tile union or dense column
pass) by fixed constants (the session's loop, ``engine._VR_DENSE_CUTOFF``)
that are right on one host only. This module replaces them with a small
model fitted on the host that serves:

  stage kinds     one linear model per stage family: "knn:host",
                  "knn:device", "knn:sharded:sN" (the device loop over
                  N shards), "vr:tile", "vr:dense"
  features        analytic per-stage vectors (``knn_features`` /
                  ``vr_features``): queries, first-round scan work scaled
                  by the scan precision's bytes, candidate rows staged,
                  top-k work, the straggler round budget, collective
                  volume (the per-round heap merge's shards*g*k; 0
                  unsharded)
  fit             ridge regression over (features, observed seconds)
                  samples from the QBS cost rings, which every executed
                  engine stage fills (``EngineStats.stage_samples``)
  calibration     ``calibrate_platform`` runs synthetic hybrid batches
                  through both loops and each requested shard count, and
                  fits from the recorded rings
  online refit    ``maybe_refit`` refits after ``_REFIT_EVERY`` new
                  samples; the planner calls it after every executed plan

Fallback contract: the model is ADVISORY. Without a model, with a kind
not fitted, or with a fit whose in-sample median relative error exceeds
``CostModel.RELIABLE_ERR``, every consumer keeps its fixed behaviour
byte for byte. ``predict`` declines (None) beyond ``EXTRAPOLATION_MAX``
times the fitted feature range. Predictions only move work between
exact paths: rows never depend on them. The math (features, fit, trims,
gates) is the reference's, so a model carried across with ``to_dict`` /
``from_dict`` makes the reference's choices on the same state.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lake import _next_pow2

COST_MODEL_VERSION = 1
_RIDGE_LAMBDA = 1e-3     # relative to mean feature scale (see ridge_fit)
_MIN_SAMPLES = 8         # per kind; fewer leaves the kind uncalibrated
_REFIT_EVERY = 32        # new observed samples between online refits

KNN_FEATURE_DIM = 7
VR_FEATURE_DIM = 5

_SCAN_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def prec_scale(precision: str) -> float:
    """Relative cost of the scan precision against fp32: fp32 -> 1.0,
    bf16 -> 0.5, int8 -> 0.25. The card's scan kernels are bound by the
    bytes of the candidate rows they read, so the scale is the element
    width's (the reference takes the same ratios from its peak rates)."""
    if precision not in _SCAN_BYTES:
        raise ValueError(f"unknown scan precision {precision!r}")
    return _SCAN_BYTES[precision] / _SCAN_BYTES["fp32"]


def knn_kind(device_loop: bool, shards: int = 0) -> str:
    """Stage-kind key for one KNN group execution."""
    if device_loop and shards:
        return f"knn:sharded:s{int(shards)}"
    return "knn:device" if device_loop else "knn:host"


def shards_of_kind(kind: str) -> Optional[int]:
    """Inverse of ``knn_kind`` for sharded kinds: the shard count, or
    None for the other kinds."""
    if kind.startswith("knn:sharded:s"):
        try:
            return int(kind.rsplit("s", 1)[1])
        except ValueError:
            return None
    return None


def loop_widths(device_loop: bool, shards: int, beam: int, tiles: int,
                seed: Optional[int] = None) -> Tuple[int, int]:
    """(first-round width, straggler/doubling width) in tiles of the
    loop's scan layout (per shard on the sharded loop) — mirrors
    ``HybridEngine._run_jobs``."""
    tiles = max(1, int(tiles))
    beam = max(1, int(beam))
    if device_loop and shards:
        s = max(1, int(shards))
        w1 = max(1, min(-(-max(1, beam // 2) // s), tiles))
        ws = max(1, _next_pow2(seed)) if seed else max(1, -(-beam // s))
        return w1, ws
    if device_loop:
        w1 = max(1, min(max(1, beam // 2), tiles))
        ws = max(beam, _next_pow2(seed)) if seed else beam
        return w1, ws
    beam_eff = max(beam, _next_pow2(beam + seed)) if seed else beam
    w = max(1, min(beam_eff, tiles))
    return w, w


def knn_features(g: int, w1: int, ws: int, cap: int, dim: int, k: int,
                 tiles: int, shards: int, precision: str
                 ) -> Tuple[float, ...]:
    """[bias, queries, first-round scan MFLOP-equivalents, candidate rows
    staged (1e6), top-k merge work (1e3), straggler round budget,
    collective volume (1e3; 0 unsharded)]."""
    g = max(1, int(g))
    w1 = max(1, int(w1))
    ws = max(1, int(ws))
    cap = max(1, int(cap))
    dim = max(1, int(dim))
    tiles = max(1, int(tiles))
    ps = prec_scale(precision)
    scan = g * w1 * cap * dim * ps / 1e6
    gather = g * w1 * cap / 1e6
    topk = g * k * math.log2(max(2.0, float(w1 * cap))) / 1e3
    rounds = float(-(-(tiles - w1) // ws)) if tiles > w1 else 1.0
    coll = (shards * g * k / 1e3) if shards else 0.0
    return (1.0, float(g), scan, gather, topk, rounds, coll)


def knn_plan_features(*, device_loop: bool, g: int, k: int, beam: int,
                      tiles: int, cap: int, dim: int, precision: str,
                      seed: Optional[int] = None, shards: int = 0
                      ) -> Tuple[float, ...]:
    """``knn_features`` with the round widths from ``loop_widths``: the
    one builder of the engine's recordings and the planner's
    predictions."""
    w1, ws = loop_widths(device_loop, shards, beam, tiles, seed)
    return knn_features(g, w1, ws, cap, dim, k, tiles, shards, precision)


def vr_features(kind: str, g: int, union_tiles: int, cap: int, dim: int,
                n: int) -> Tuple[float, ...]:
    """[bias, queries, GEMM MFLOPs, rows staged (1e6), mask decode (1e6)]
    for one V.R group; the dense pass touches every row, the tile pass
    the pow2-padded union."""
    g = max(1, int(g))
    cap = max(1, int(cap))
    dim = max(1, int(dim))
    if kind == "vr:dense":
        rows = float(max(1, n))
    else:
        rows = float(_next_pow2(max(1, union_tiles)) * cap)
    return (1.0, float(g), g * rows * dim / 1e6, rows * dim / 1e6,
            g * rows / 1e6)


def ridge_fit(X: np.ndarray, y: np.ndarray,
              lam: float = _RIDGE_LAMBDA) -> np.ndarray:
    """Ridge weights ``(XtX + lam*scale*I)^-1 Xt y`` with the regularizer
    scaled to the mean diagonal of XtX, so one lambda works across
    feature magnitudes."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    xtx = X.T @ X
    scale = float(np.trace(xtx)) / max(1, xtx.shape[0])
    reg = lam * max(scale, 1e-12) * np.eye(xtx.shape[0])
    return np.linalg.solve(xtx + reg, X.T @ y)


def steady_samples(X: np.ndarray, y: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The least observed seconds per distinct feature row: repeated
    executions of one stage shape re-record the same row, and the first
    carries one-off costs (on the card: kernel loads and first
    allocations), an outlier that would dominate a least-squares fit."""
    best: Dict[Tuple, float] = {}
    for row, sec in zip(X, y):
        key = tuple(row)
        if key not in best or sec < best[key]:
            best[key] = float(sec)
    return (np.asarray([list(k) for k in best], np.float64),
            np.asarray([best[k] for k in best], np.float64))


class CostModel:
    """Per-host collection of per-stage-kind ridge models.

    ``kinds`` maps a stage kind to {"w": weights, "n": training samples,
    "err": in-sample median relative error, "hi": per-feature training
    max}; ``host`` records the calibration host's fingerprint. The dict
    form (``to_dict``) is the reference's ``cost_model.json``."""

    #: in-sample median relative error above which a fitted kind no
    #: longer STEERS decisions (its predictions are still reported)
    RELIABLE_ERR = 1.0

    #: predictions are declined once any feature exceeds this multiple of
    #: the largest value seen in training: ridge weights can be negative,
    #: so far extrapolation inverts
    EXTRAPOLATION_MAX = 4.0

    def __init__(self, kinds: Optional[Dict] = None,
                 host: Optional[Dict] = None):
        self.kinds: Dict[str, Dict] = dict(kinds or {})
        self.host: Dict = dict(host or {})
        # online-refit cursor: QBSTable.cost_total at the last fit
        self._fit_seen = 0
        # seconds the last calibration sweep spent in each loop kind
        self.sweep_s: Dict[str, float] = {}

    def calibrated(self, *kinds: str) -> bool:
        """True when every named kind has a fitted model (no names: when
        ANY kind is fitted)."""
        if not kinds:
            return bool(self.kinds)
        return all(k in self.kinds for k in kinds)

    def reliable(self, *kinds: str) -> bool:
        """True when every named kind is fitted AND its in-sample error is
        at most ``RELIABLE_ERR``: the gate of every decision."""
        return all(k in self.kinds
                   and float(self.kinds[k].get("err", np.inf))
                   <= self.RELIABLE_ERR
                   for k in kinds)

    def predict(self, kind: str, feats: Sequence[float]
                ) -> Optional[float]:
        """Predicted stage seconds, or None ("no opinion") when the kind
        is not fitted, the feature vector does not match the fit, or a
        feature lies beyond ``EXTRAPOLATION_MAX`` times its training
        max."""
        ent = self.kinds.get(kind)
        if ent is None:
            return None
        w = np.asarray(ent["w"], np.float64)
        x = np.asarray(feats, np.float64)
        if x.shape != w.shape:
            return None
        hi = ent.get("hi")
        if hi is not None and np.any(
                x > self.EXTRAPOLATION_MAX * np.asarray(hi, np.float64)
                + 1e-12):
            return None
        return float(max(float(w @ x), 1e-9))

    def fit_from_qbs(self, qbs, min_samples: int = _MIN_SAMPLES
                     ) -> List[str]:
        """Fit every stage kind with at least ``min_samples`` samples in
        the QBS cost rings; returns the kinds (re)fitted. Kinds below the
        floor keep their previous fit (or stay unfitted)."""
        fitted: List[str] = []
        for kind in sorted(qbs.cost):
            s = qbs.cost_samples(kind)
            if s is None:
                continue
            X, y = s
            if len(y) < min_samples:
                continue
            X, y = steady_samples(X, y)
            w = ridge_fit(X, y)
            pred = np.maximum(X @ w, 1e-9)
            rel = np.abs(pred - y) / np.maximum(y, 1e-9)
            # trimmed refit: a shape executed once keeps its one-off cost
            # in, and one 100x outlier wrecks a ridge fit; drop
            # order-of-magnitude residuals and refit once, keeping at
            # least half the data
            keep = rel <= max(5.0 * float(np.median(rel)), 1.0)
            if int(keep.sum()) >= max(4, len(y) // 2) \
                    and int(keep.sum()) < len(y):
                w = ridge_fit(X[keep], y[keep])
                pred = np.maximum(X[keep] @ w, 1e-9)
                X, y = X[keep], y[keep]
            err = float(np.median(np.abs(pred - y)
                                  / np.maximum(y, 1e-9)))
            self.kinds[kind] = {"w": [float(v) for v in w],
                                "n": int(len(y)), "err": err,
                                "hi": [float(v) for v in X.max(axis=0)]}
            fitted.append(kind)
        self._fit_seen = int(qbs.cost_total)
        return fitted

    def maybe_refit(self, qbs) -> bool:
        """Online recalibration: refit once ``_REFIT_EVERY`` new stage
        samples arrived since the last fit (a no-op in between)."""
        if int(qbs.cost_total) - self._fit_seen < _REFIT_EVERY:
            return False
        return bool(self.fit_from_qbs(qbs))

    def to_dict(self) -> Dict:
        return {"version": COST_MODEL_VERSION, "host": self.host,
                "kinds": self.kinds}

    @classmethod
    def from_dict(cls, d: Dict) -> "CostModel":
        return cls(kinds=d.get("kinds") or {}, host=d.get("host") or {})


def host_fingerprint(device) -> Dict:
    """What a calibration was measured on (the reference's keys), so a
    model carried to another host is recognizably stale; it stays
    advisory either way."""
    return {"cpu_count": os.cpu_count() or 1,
            "device_count": torch.cuda.device_count(),
            "backend": torch.device(device).type}


# ---------------------------------------------------------------------------
# Calibration sweep
# ---------------------------------------------------------------------------
def _calibration_batches(p, rng: np.random.Generator, batch: int):
    """Synthetic hybrid batches over the platform's own columns, covering
    every stage family: plain V.K at two k, filtered V.K, small-radius
    V.R (the tile route) and large-radius V.R (the dense pass). The
    reference's draws, so both packages sweep the same queries."""
    from repro_torch.core import query as Q
    table = p.table
    attr = next(iter(table.vector))
    col = np.asarray(table.vector[attr], np.float32)
    n = len(col)
    num = next(iter(table.numeric), None)
    # radii from an anchor's true distance profile: r_small about its
    # 10th-nearest-neighbour distance (a few tiles: the tile route),
    # r_large past its farthest row (the dense pass)
    anchor = col[rng.integers(0, n)]
    d = np.sort(np.sqrt(((col - anchor[None, :]) ** 2).sum(1)))
    d = d[d > 0]
    r_small = float(d[min(10, len(d) - 1)]) if len(d) else 1.0
    r_large = float(d[-1] * 1.1 + 1e-6) if len(d) else 1.0

    def vk(k=8):
        v = col[rng.integers(0, n)] + rng.normal(0, 1e-3, col.shape[1])
        return Q.VK.of(attr, v.astype(np.float32), k)

    def vr(radius):
        v = col[rng.integers(0, n)]
        return Q.VR.of(attr, v, radius)

    def vr_near(radius):
        # jittered copies of the SAME anchor keep the batch's leaf union
        # a handful of tiles, so the device path takes the tile route
        v = anchor + rng.normal(0, 1e-3, col.shape[1])
        return Q.VR.of(attr, v.astype(np.float32), radius)

    batches = [[vk(8) for _ in range(batch)],
               [vk(32) for _ in range(max(2, batch // 2))],
               [vr_near(r_small) for _ in range(batch)],
               [vr(r_large) for _ in range(max(2, batch // 2))]]
    if num is not None:
        nv = np.asarray(table.numeric[num], np.float64)
        lo, hi = float(np.quantile(nv, 0.2)), float(np.quantile(nv, 0.8))
        batches.append([Q.And.of(Q.NR(num, lo, hi), vk())
                        for _ in range(batch)])
        batches.append([Q.And.of(vr_near(r_small), vk(4))
                        for _ in range(max(2, batch // 2))])
    return batches


def calibrate_platform(p, *, shard_counts: Optional[Sequence[int]] = None,
                       batch: int = 16, repeats: int = 2,
                       seed: int = 0) -> CostModel:
    """Run the calibration sweep and fit (or refresh) ``p.cost_model``.

    The synthetic batches run through the host loop, the device loop and
    the device loop over each of ``shard_counts`` (default: the
    platform's ``default_shards``, when set), each at four sizes (one
    sample per stage group and execution, so the sizes multiply the
    samples past the fit floor and spread the group size); the engine's
    stage timers fill the QBS cost rings, and one ridge model is fitted
    per observed kind. Any shard count runs on the devices there are, so
    none is dropped (the reference keeps those up to its device count).
    Warm the platform's engines first: their first launches carry
    one-off costs. ``sweep_s`` on the returned (installed) model holds
    the seconds each loop took ("host", "device", "sharded:sN")."""
    rng = np.random.default_rng(seed)
    if shard_counts is None:
        shard_counts = [s for s in {p.default_shards or 0} if s]
    shard_counts = sorted({int(s) for s in shard_counts if int(s) >= 1})
    sessions = [(p.session(device_loop=False, shards=0), False, "host"),
                (p.session(device_loop=True, shards=0), True, "device")]
    for s in shard_counts:
        sessions.append((p.session(device_loop=True, shards=s), True,
                         f"sharded:s{s}"))
    sweep = {name: 0.0 for _, _, name in sessions}
    for _ in range(max(1, repeats)):
        batches = _calibration_batches(p, rng, batch)
        for sess, dl, name in sessions:
            t0 = time.time()
            for qs in batches:
                for sub in (qs, qs[::2], qs[1::2],
                            qs[:max(1, len(qs) // 4)]):
                    if sub:
                        sess.plan(sub, device_loop=dl).execute()
            if p.device.type == "cuda":
                torch.cuda.synchronize(p.device)
            sweep[name] += time.time() - t0
    model = p.cost_model if p.cost_model is not None else CostModel()
    model.fit_from_qbs(p.qbs)
    model.host = host_fingerprint(p.device)
    model.sweep_s = sweep
    p.cost_model = model
    return model
