"""Hyperspace Transformation (paper §5.2.2).

T = R·S from the eigendecomposition of the data covariance C = VΛVᵀ:
R = V (orthonormal rotation), S = √Λ (positive diagonal scaling), subject to
the paper's invertibility constraints (eq. 7):
  (1) T ∈ R^{n×n} — no dimension loss;
  (2) R orthonormal;
  (3) S positive definite diagonal.

Step 4 (query-aware optimization) perturbs (R, S) with a compact
parameterization that PRESERVES the constraints by construction:
  R(θ) = V · Π Givens(i_k, j_k, θ_k)      (still orthonormal)
  S(δ) = diag(s0 · exp(δ))                 (still positive)
so MORBO can search freely in (θ, δ) without projection steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class HyperspaceTransform:
    r: np.ndarray        # (n, n) orthonormal
    s: np.ndarray        # (n,) positive scales
    mean: np.ndarray     # (n,) data mean (centering)

    @property
    def t(self) -> np.ndarray:
        return self.r * self.s[None, :]

    def apply(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean) @ self.t

    def inverse(self, y: np.ndarray) -> np.ndarray:
        return (np.asarray(y, np.float32) / self.s[None, :]) @ self.r.T \
            + self.mean

    def check_constraints(self, atol: float = 1e-4) -> bool:
        n = self.r.shape[0]
        ortho = np.allclose(self.r.T @ self.r, np.eye(n), atol=atol)
        return bool(ortho and np.all(self.s > 0))


def init_transform(d: np.ndarray, *, min_eig: float = 1e-6,
                   whiten: bool = False) -> HyperspaceTransform:
    """Steps 1-3: covariance -> eigendecomposition -> T = R·S.

    ``whiten=False`` follows the paper: S = √Λ *stretches* high-variance
    (information-rich) directions; whiten=True inverts the scaling (ablation).
    """
    x = np.asarray(d, np.float32)
    mean = x.mean(axis=0)
    xc = x - mean
    c = (xc.T @ xc) / max(1, len(x) - 1)
    eigval, eigvec = np.linalg.eigh(c.astype(np.float64))
    order = np.argsort(eigval)[::-1]
    eigval, eigvec = eigval[order], eigvec[:, order]
    s = np.sqrt(np.maximum(eigval, min_eig))
    if whiten:
        s = 1.0 / s
    return HyperspaceTransform(r=eigvec.astype(np.float32),
                               s=s.astype(np.float32),
                               mean=mean.astype(np.float32))


# ---------------------------------------------------------------------------
# Query-aware parameterization (Step 4)
# ---------------------------------------------------------------------------
def _givens(n: int, i: int, j: int, theta: float) -> np.ndarray:
    g = np.eye(n, dtype=np.float32)
    c, s_ = np.cos(theta), np.sin(theta)
    g[i, i] = c
    g[j, j] = c
    g[i, j] = -s_
    g[j, i] = s_
    return g


def perturb(base: HyperspaceTransform, theta: Sequence[float],
            delta: Sequence[float],
            pairs: Optional[List[Tuple[int, int]]] = None
            ) -> HyperspaceTransform:
    """R(θ), S(δ) around the eigen initialization — constraint-preserving."""
    n = base.r.shape[0]
    theta = np.asarray(theta, np.float32)
    delta = np.asarray(delta, np.float32)
    if pairs is None:
        pairs = default_pairs(n, len(theta))
    r = base.r.copy()
    for (i, j), th in zip(pairs, theta):
        r = r @ _givens(n, i, j, float(th))
    k = min(len(delta), n)
    s = base.s.copy()
    s[:k] = s[:k] * np.exp(np.clip(delta[:k], -3, 3))
    return HyperspaceTransform(r=r, s=s, mean=base.mean)


def default_pairs(n: int, k: int) -> List[Tuple[int, int]]:
    """Rotation planes: adjacent leading dims first (highest variance)."""
    out = []
    i = 0
    while len(out) < k:
        j = (i + 1) % n
        if i != j:
            out.append((min(i, j), max(i, j)))
        i = (i + 1) % n
        if n <= 1:
            break
    return out[:k]
