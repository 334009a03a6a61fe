"""Feature embedding measurement (paper §5.1.2). Port of
``repro/core/measurement.py``.

Score = w1·S1 + w2·S2 + w3·S3 (eq. 1):
  S1 — extrinsic: downstream query stats from the QBS table
  S2 — intrinsic generalization: Silhouette Coefficient of the clustered
       embedding (eq. 2-4)
  S3 — intrinsic fidelity: 1 − normalized Fréchet distance (eq. 5) between
       the original-feature distribution and a linear-decoder
       reconstruction.

As in the reference, S3 is the Fréchet distance between Gaussian moments
of the raw features and their ridge-regression reconstruction from the
embedding (no diffusion model or Inception features offline). Host numpy
in float64 where the reference is, so both packages score a model alike
to the last bits; it runs once per candidate model on a sample, off any
query path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# weights from the paper's experimental validation (§5.1.2):
IN_WEIGHTS = (0.0, 0.3, 0.7)          # method = IN (cold start)
INEX_WEIGHTS = (0.2, 0.3, 0.5)        # method = IN + EX


# ---------------------------------------------------------------------------
# K-means (used by SC and downstream evaluations)
# ---------------------------------------------------------------------------
def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (labels, centroids). Plain Lloyd with k-means++ init."""
    rng = np.random.default_rng(seed)
    n = len(x)
    # k-means++ seeding
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=p)])
    c = np.stack(centers)
    for _ in range(iters):
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1) if n * k <= 4_000_000 \
            else _blocked_d2(x, c)
        lab = d2.argmin(1)
        for j in range(k):
            m = lab == j
            if m.any():
                c[j] = x[m].mean(0)
    return lab, c


def _blocked_d2(x, c, block: int = 4096):
    out = np.empty((len(x), len(c)), np.float32)
    for i in range(0, len(x), block):
        xb = x[i:i + block]
        out[i:i + block] = (np.sum(xb * xb, 1, keepdims=True)
                            - 2 * xb @ c.T + np.sum(c * c, 1))
    return out


# ---------------------------------------------------------------------------
# S2: Silhouette Coefficient
# ---------------------------------------------------------------------------
def silhouette(x: np.ndarray, labels: np.ndarray,
               sample: int = 2048, seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    n = len(x)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    xs, ls = x[idx], labels[idx]
    uniq = np.unique(labels)
    if len(uniq) < 2:
        return 0.0
    # distances sample -> all points, grouped by label
    svals = []
    d = np.sqrt(np.maximum(_blocked_d2(xs, x), 0.0))  # (S, N)
    for i in range(len(xs)):
        own = labels == ls[i]
        n_own = own.sum()
        if n_own <= 1:
            continue
        a = d[i][own].sum() / (n_own - 1)
        b = np.inf
        for u in uniq:
            if u == ls[i]:
                continue
            m = labels == u
            if m.any():
                b = min(b, d[i][m].mean())
        svals.append((b - a) / max(a, b, 1e-12))
    return float(np.mean(svals)) if svals else 0.0


def sc_score(x: np.ndarray, k: int = 8, seed: int = 0) -> float:
    lab, _ = kmeans(np.asarray(x, np.float32), k, seed=seed)
    return silhouette(np.asarray(x, np.float32), lab, seed=seed)


# ---------------------------------------------------------------------------
# S3: Fréchet distance fidelity
# ---------------------------------------------------------------------------
def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    w = np.maximum(w, 0.0)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    diff = mu1 - mu2
    s1h = _sqrtm_psd(cov1)
    cross = _sqrtm_psd(s1h @ cov2 @ s1h)
    fd = float(diff @ diff + np.trace(cov1) + np.trace(cov2)
               - 2.0 * np.trace(cross))
    return max(fd, 0.0)


def gaussian_moments(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = np.asarray(x, np.float64)
    mu = x.mean(0)
    xc = x - mu
    cov = (xc.T @ xc) / max(1, len(x) - 1)
    return mu, cov


def fidelity_score(raw: np.ndarray, emb: np.ndarray,
                   ridge: float = 1e-3) -> float:
    """S3 = 1 − normalized FD(raw, linear-decoder reconstruction)."""
    raw = np.asarray(raw, np.float64)
    emb = np.asarray(emb, np.float64)
    g = emb.T @ emb + ridge * len(emb) * np.eye(emb.shape[1])
    w = np.linalg.solve(g, emb.T @ raw)
    recon = emb @ w
    fd = frechet_distance(*gaussian_moments(raw), *gaussian_moments(recon))
    # normalize by the raw distribution's own spread
    scale = float(np.trace(gaussian_moments(raw)[1])) + 1e-12
    return float(np.clip(1.0 - fd / scale, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Combined scoring (eq. 1 / eq. 6)
# ---------------------------------------------------------------------------
@dataclass
class ModelScore:
    model: str
    s1: float
    s2: float
    s3: float

    def score(self, method: str = "IN+EX") -> float:
        if method == "SC":
            return self.s2
        if method == "IN":
            w = IN_WEIGHTS
            return w[1] * self.s2 + w[2] * self.s3
        w = INEX_WEIGHTS
        return w[0] * self.s1 + w[1] * self.s2 + w[2] * self.s3


def measure_models(raw: np.ndarray,
                   embeddings: Dict[str, np.ndarray],
                   extrinsic: Optional[Dict[str, float]] = None,
                   k: int = 8, sample: int = 4096, seed: int = 0
                   ) -> List[ModelScore]:
    """Score every candidate embedding model; sampled per paper §7.9."""
    rng = np.random.default_rng(seed)
    n = len(raw)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    out = []
    for name, emb in embeddings.items():
        s2 = sc_score(emb[idx], k=k, seed=seed)
        s3 = fidelity_score(raw[idx], emb[idx])
        s1 = (extrinsic or {}).get(name, 0.0)
        out.append(ModelScore(model=name, s1=s1, s2=s2, s3=s3))
    return out


def select_model(scores: Sequence[ModelScore],
                 method: str = "IN+EX") -> ModelScore:
    return max(scores, key=lambda s: s.score(method))
