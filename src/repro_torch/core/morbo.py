"""MORBO-style multi-objective Bayesian optimization (paper Algorithm 1).
Port of ``repro/core/morbo.py``: host numpy, the port's own copy.

Trust-region collaborative BO over a box-bounded parameter space:
  * n_tr trust regions, each with a local GP surrogate (RBF, exact Cholesky)
  * candidate selection by Thompson sampling on a random-weight Chebyshev
    scalarization of the (minimized) objectives within each region
  * success/failure counters expand/shrink the region; regions below L_min
    are terminated and re-initialized (Algorithm 1 lines 9-13)
  * returns the evaluated set and the approximate Pareto front

Two entry points share one implementation: ``morbo_minimize``, the
closed loop, and ``MorboDriver``, an ask/tell interface whose ``ask()``
proposes one batch of points and ``tell(y)`` takes their measured
objectives back; the online re-optimization controller
(``repro_torch.core.reopt``) steps one ask/tell pair at a time between
serving micro-batches.

The draws come from ``np.random.default_rng(seed)`` in the reference's
order, so both packages propose the same points bit for bit for the same
seed and tells.

Robustness (the tuner runs unattended): the exact-GP Cholesky can fail
on duplicate or degenerate evaluation points, which occur once trust
regions shrink onto one optimum. ``GP`` retries with escalating jitter
and, when every factorization fails, degrades to a prior-only surrogate
(posterior = prior mean/std everywhere), so Thompson sampling becomes
random candidate selection for that region instead of raising
``LinAlgError`` into the serving loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Tiny exact GP
# ---------------------------------------------------------------------------
class GP:
    def __init__(self, x: np.ndarray, y: np.ndarray, noise: float = 1e-4):
        self.x = np.asarray(x, np.float64)
        self.y = np.asarray(y, np.float64)
        self.mu = self.y.mean() if len(y) else 0.0
        self.sd = self.y.std() + 1e-9
        yn = (self.y - self.mu) / self.sd
        d2 = self._d2(self.x, self.x)
        med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
        self.ls2 = max(med, 1e-9)
        k = np.exp(-0.5 * d2 / self.ls2)
        # duplicate/degenerate evaluation points make K singular at the
        # base jitter; escalate before giving up (prior-only fallback)
        self.chol = None
        self.alpha = None
        for jitter in (noise, 1e-3, 1e-2, 1e-1, 1.0):
            try:
                chol = np.linalg.cholesky(k + jitter * np.eye(len(x)))
                self.chol = chol
                self.alpha = np.linalg.solve(
                    chol.T, np.linalg.solve(chol, yn))
                break
            except np.linalg.LinAlgError:
                continue

    @property
    def degenerate(self) -> bool:
        """True when no factorization succeeded: ``posterior`` returns the
        prior, so sampling degrades to random candidate selection."""
        return self.chol is None

    @staticmethod
    def _d2(a, b):
        return ((a[:, None, :] - b[None]) ** 2).sum(-1)

    def posterior(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        xq = np.asarray(xq, np.float64)
        if self.degenerate:
            n = len(xq)
            return np.full(n, self.mu), np.full(n, self.sd)
        ks = np.exp(-0.5 * self._d2(xq, self.x) / self.ls2)
        mean = ks @ self.alpha
        v = np.linalg.solve(self.chol, ks.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        return mean * self.sd + self.mu, np.sqrt(var) * self.sd

    def sample(self, xq: np.ndarray, rng) -> np.ndarray:
        m, s = self.posterior(xq)
        return m + s * rng.standard_normal(len(m))


# ---------------------------------------------------------------------------
# Pareto helpers
# ---------------------------------------------------------------------------
def pareto_mask(y: np.ndarray) -> np.ndarray:
    """y: (N, M) objectives, all MINIMIZED. True = non-dominated."""
    n = len(y)
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates = np.all(y <= y[i], axis=1) & np.any(y < y[i], axis=1)
        if dominates.any():
            mask[i] = False
    return mask


@dataclass
class TrustRegion:
    center: np.ndarray
    length: float
    success: int = 0
    failure: int = 0


@dataclass
class MorboResult:
    x: np.ndarray          # (N, D) evaluated points
    y: np.ndarray          # (N, M) objective values (minimized)
    pareto: np.ndarray     # bool mask over rows
    n_restarts: int = 0

    def best_scalarized(self, weights: Sequence[float]) -> np.ndarray:
        w = np.asarray(weights, np.float64)
        scores = (self.y * w).sum(1)
        return self.x[int(np.argmin(scores))]


# ---------------------------------------------------------------------------
# Incremental driver (ask/tell)
# ---------------------------------------------------------------------------
class MorboDriver:
    """One MORBO run as an ask/tell state machine.

    Protocol: ``x = driver.ask()`` proposes a batch of points in BOX
    coordinates; the caller evaluates the vector objective at each row and
    calls ``driver.tell(y)`` with the (B, n_objectives) results before the
    next ``ask()``. The first ask returns the ``n_init`` space-filling
    points; every later ask serves one trust region round-robin —
    ``iters * n_tr`` post-init ask/tell pairs reproduce ``morbo_minimize``
    exactly. ``result()`` may be read at any point between pairs (the
    online tuner stops early when its step budget runs out)."""

    def __init__(self, bounds: Tuple[np.ndarray, np.ndarray], *,
                 n_objectives: int, n_init: int = 8, n_tr: int = 2,
                 batch: int = 4, n_cand: int = 256, l_init: float = 0.4,
                 l_min: float = 0.05, l_max: float = 1.0, seed: int = 0):
        self.lo, self.hi = (np.asarray(b, np.float64) for b in bounds)
        self.dim = len(self.lo)
        self.n_objectives = n_objectives
        self.n_init = n_init
        self.n_tr = n_tr
        self.batch = batch
        self.n_cand = n_cand
        self.l_init, self.l_min, self.l_max = l_init, l_min, l_max
        self.rng = np.random.default_rng(seed)
        self.x_unit = np.empty((0, self.dim))
        self.y = np.empty((0, n_objectives))
        self.trs: Optional[List[TrustRegion]] = None
        self._tr_idx = 0
        self.n_restarts = 0
        self.n_evals = 0
        # context of the outstanding ask (None = tell() not expected)
        self._pending: Optional[np.ndarray] = None   # unit coords
        self._pending_w: Optional[np.ndarray] = None

    # ------------------------------------------------------------ coords
    def _to_box(self, u: np.ndarray) -> np.ndarray:
        return self.lo + u * (self.hi - self.lo)

    # ------------------------------------------------------------- ask
    def ask(self) -> np.ndarray:
        """Propose the next batch of points (box coordinates)."""
        if self._pending is not None:
            raise RuntimeError("ask() called with a tell() outstanding")
        if len(self.x_unit) < self.n_init:
            u = self.rng.random((self.n_init, self.dim))
            self._pending, self._pending_w = u, None
            return self._to_box(u)
        if self.trs is None:
            self.trs = [TrustRegion(
                center=self.x_unit[self.rng.integers(len(self.x_unit))]
                .copy(), length=self.l_init) for _ in range(self.n_tr)]
        tr = self.trs[self._tr_idx]
        inside = np.all(np.abs(self.x_unit - tr.center)
                        <= tr.length / 2 + 1e-9, axis=1)
        xs = self.x_unit[inside] if inside.sum() >= 2 else self.x_unit
        ys = self.y[inside] if inside.sum() >= 2 else self.y
        gps = [GP(xs, ys[:, j]) for j in range(self.n_objectives)]
        # Thompson-sampled Chebyshev scalarization (degenerate GPs sample
        # the prior — random selection, never a LinAlgError)
        cand = tr.center + (self.rng.random((self.n_cand, self.dim)) - 0.5) \
            * tr.length
        cand = np.clip(cand, 0.0, 1.0)
        w = self.rng.dirichlet(np.ones(self.n_objectives))
        samples = np.stack([g.sample(cand, self.rng) for g in gps], axis=1)
        ref_pt = self.y.min(0)
        cheb = np.max(w * (samples - ref_pt), axis=1)
        picks = np.argsort(cheb)[:self.batch]
        self._pending, self._pending_w = cand[picks], w
        return self._to_box(cand[picks])

    # ------------------------------------------------------------- tell
    def tell(self, y: np.ndarray):
        """Feed back the objectives for the last ``ask()`` batch."""
        if self._pending is None:
            raise RuntimeError("tell() without an outstanding ask()")
        yb = np.asarray(y, np.float64).reshape(len(self._pending),
                                               self.n_objectives)
        xb, w = self._pending, self._pending_w
        self._pending = self._pending_w = None
        before = pareto_mask(self.y).sum() if len(self.y) else 0
        prev_min = self.y.min(0) if len(self.y) else None
        self.x_unit = np.concatenate([self.x_unit, xb])
        self.y = np.concatenate([self.y, yb])
        self.n_evals += len(yb)
        if w is None:              # init batch: no trust-region update
            return
        tr = self.trs[self._tr_idx]
        self._tr_idx = (self._tr_idx + 1) % self.n_tr
        after = pareto_mask(self.y).sum()
        improved = after > before or (prev_min is not None
                                      and (yb.min(0) < prev_min).any())
        if improved:
            tr.success += 1
            tr.failure = 0
        else:
            tr.failure += 1
            tr.success = 0
        if tr.success >= 2:
            tr.length = min(tr.length * 1.6, self.l_max)
            tr.success = 0
        elif tr.failure >= 2:
            tr.length *= 0.5
            tr.failure = 0
        # recenter on the best scalarized point
        ref_pt = self.y.min(0)
        scores = np.max(w * (self.y - ref_pt), axis=1)
        tr.center = self.x_unit[int(np.argmin(scores))].copy()
        if tr.length < self.l_min:   # terminate + reinitialize (line 9-11)
            self.n_restarts += 1
            tr.center = self.rng.random(self.dim)
            tr.length = self.l_init
            tr.success = tr.failure = 0

    # ----------------------------------------------------------- result
    def result(self) -> MorboResult:
        x_box = self._to_box(self.x_unit)
        return MorboResult(x=x_box, y=self.y.copy(),
                           pareto=pareto_mask(self.y),
                           n_restarts=self.n_restarts)


def morbo_minimize(f: Callable[[np.ndarray], np.ndarray],
                   bounds: Tuple[np.ndarray, np.ndarray],
                   *, n_objectives: int, n_init: int = 8, iters: int = 10,
                   n_tr: int = 2, batch: int = 4, n_cand: int = 256,
                   l_init: float = 0.4, l_min: float = 0.05,
                   l_max: float = 1.0, seed: int = 0) -> MorboResult:
    """Minimize the vector objective f over the box [lo, hi] — the closed
    ask/tell loop over ``MorboDriver``."""
    driver = MorboDriver(bounds, n_objectives=n_objectives, n_init=n_init,
                         n_tr=n_tr, batch=batch, n_cand=n_cand,
                         l_init=l_init, l_min=l_min, l_max=l_max, seed=seed)
    for _ in range(1 + iters * n_tr):      # 1 init ask + iters x n_tr
        xb = driver.ask()
        driver.tell(np.stack([np.asarray(f(x), np.float64) for x in xb]))
    return driver.result()
