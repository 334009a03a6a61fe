"""Hyperspace Movement — Local Parallelized Gravitational Field (paper
§5.2.3), and the paper's HIBOG baseline (``hibog``). Port of
``repro/core/lpgf.py``.

The point matrix stays a host numpy array between steps, as in the
reference; each step uploads it to ``device`` and evaluates the
radius-masked all-pairs force there: through ``ops.lpgf_force`` when
N <= ``block``, else per 4096-row tile through ``_tile_disp`` (the
pairwise kernel plus one fp32 GEMM).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

# ``_tile_disp`` materialises several (rows, N) intermediates; each
# 4096-row tile is evaluated in row chunks of this many rows to bound
# device memory (~0.8 GB per intermediate at N = 200k). Every row's
# displacement depends on that row alone, so the chunking does not
# change what is computed.
_ROW_CHUNK = 1024


def mean_nn_distance(x, sample: int = 4096, seed: int = 0,
                     device=None) -> float:
    """G: average distance from each point to its nearest neighbor."""
    n = len(x)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    xt = torch.as_tensor(np.asarray(x, np.float32),
                         device=resolve_device(device))
    d, _ = ops.topk_l2_blocked(xt[torch.as_tensor(idx, device=xt.device)],
                               xt, k=2)
    # k=2: first hit is the point itself (distance 0)
    d = d.cpu().numpy()
    return float(np.sqrt(np.maximum(d[:, 1], 0.0)).mean())


def lpgf_step(x, radius: float, g_mean: float, step: float = 0.5,
              block: int = 4096, device=None) -> np.ndarray:
    """One force-and-move step. x: (N, D) host array -> moved (N, D).

    Displacement = step * F / sum(w) — the weight-normalized pull."""
    device = resolve_device(device)
    xj = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = x.shape[0]
    if n <= block:
        f, w = ops.lpgf_force(xj, float(radius), float(g_mean))
        disp = f / torch.clamp_min(w, 1.0)[:, None]
        return (xj + step * disp).cpu().numpy()
    out = np.empty_like(np.asarray(x, np.float32))
    for i in range(0, n, block):
        tile = xj[i:i + block]
        disp = _tile_disp(tile, xj, radius, g_mean)
        out[i:i + block] = (tile + step * disp).cpu().numpy()
    return out


def _tile_disp_rows(tile, allpts, r2, g_mean, inv_c):
    d2 = ops.pairwise_sq_l2(tile, allpts)                  # (T, N)
    # self-distances: exact zeros — mask them
    d2m = torch.where(d2 <= 1e-12, torch.full_like(d2, 1e30), d2)
    del d2
    d1sq = torch.min(d2m, dim=1).values                    # nearest^2
    thresh_near = g_mean * torch.sqrt(d1sq)
    in_r = d2m <= r2
    near = d2m <= thresh_near[:, None]
    far = (~near) & in_r
    w = torch.where(far, d1sq[:, None] / torch.clamp_min(d2m, 1e-12), 0.0)
    del d2m, far
    w = w + torch.where(near & in_r, inv_c, 0.0)
    # F_i = sum_j w_ij (p_j - p_i) = (w @ P) - (sum_j w_ij) * p_i
    wsum = torch.sum(w, dim=1, keepdim=True)
    ops.require_ieee_matmul(w)
    f = w @ allpts - wsum * tile
    return f / torch.clamp_min(wsum, 1.0)


def _tile_disp(tile, allpts, radius, g_mean, c: float = 1.1):
    """Weight-normalized displacement on `tile` points from ALL points."""
    # the reference traces radius, g_mean and c as fp32 scalars, so the
    # squared radius and 1/c are fp32 operations
    r32 = np.float32(radius)
    r2 = float(r32 * r32)
    g_mean = float(np.float32(g_mean))
    inv_c = float(np.float32(1.0) / np.float32(c))
    return torch.cat([
        _tile_disp_rows(tile[i:i + _ROW_CHUNK], allpts, r2, g_mean, inv_c)
        for i in range(0, tile.shape[0], _ROW_CHUNK)])


def lpgf(x, *, r_mult: float = 7.5, iters: int = 2, step: float = 0.5,
         g_mean: Optional[float] = None, block: int = 4096,
         seed: int = 0, device=None) -> np.ndarray:
    """Full LPGF movement: returns the moved copy of x."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    out = x.copy()
    for _ in range(iters):
        g = g_mean if g_mean is not None else mean_nn_distance(
            out, seed=seed, device=device)
        out = lpgf_step(out, radius=r_mult * g, g_mean=g, step=step,
                        block=block, device=device)
    return out


def hibog(x, *, k: int = 8, iters: int = 2, step: float = 0.5,
          device=None) -> np.ndarray:
    """HIBOG baseline (Li et al. 2021): K-nearest attraction, for the
    paper's comparison experiments (Table 6). Each iteration moves every
    point by ``step`` times the mean offset to its k nearest others,
    found by ``ops.topk_l2_blocked`` (on the card, the ``topk_l2``
    kernel; the point itself comes first, at distance 0)."""
    device = resolve_device(device)
    out = np.asarray(x, np.float32).copy()
    for _ in range(iters):
        xj = torch.as_tensor(out, device=device)
        _, idx = ops.topk_l2_blocked(xj, xj, k=k + 1)
        nbrs = out[idx.cpu().numpy()[:, 1:]]               # (N, k, D)
        f = (nbrs - out[:, None, :]).mean(axis=1)
        out = out + step * f
    return out
