"""Plain PyTorch versions of the kernels: they define the semantics.

Counterparts of ``repro/kernels/ref.py``. The CPU tests hold them to the
JAX functions; ``chip_smoke.py`` holds each CUDA kernel to them on the
card. A wrapper runs them for a tensor that lies on the CPU.

Tie law: ``lax.top_k`` is stable (among equal values the lower index
wins) and ``torch.topk`` promises no tie order, so every top-k here goes
through ``stable_topk``, which ranks packed (distance, index) keys.
"""
from __future__ import annotations

import torch


def stable_topk(d: torch.Tensor, k: int):
    """The k smallest entries of each row of ``d`` (non-negative fp32 or
    +inf, no NaN), ascending; equal values order by the lower column.

    The fp32 bit pattern of a non-negative float is order-preserving as
    an integer, so (bits << 32) | column is a unique int64 key whose
    order is the (value, column) order: one ``torch.topk`` over the keys
    has no ties left to break."""
    d = d.float().contiguous() + 0.0          # -0.0 -> +0.0: one key for 0
    n = d.shape[-1]
    bits = d.view(torch.int32).to(torch.int64)
    cols = torch.arange(n, device=d.device, dtype=torch.int64)
    key = (bits << 32) | cols
    kv, _ = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    idx = kv & 0xFFFFFFFF
    return torch.gather(d, -1, idx), idx


def pairwise_sq_l2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. q: (M, D), p: (N, D) -> (M, N) fp32."""
    q = q.float()
    p = p.float()
    qq = torch.sum(q * q, dim=1, keepdim=True)
    pp = torch.sum(p * p, dim=1, keepdim=True).T
    d = qq + pp - 2.0 * (q @ p.T)
    return torch.clamp_min(d, 0.0)


def topk_l2(q: torch.Tensor, p: torch.Tensor, k: int):
    """k nearest points of p for each q row: (sq_dists (M, k) ascending,
    indices (M, k) int64). Requires k <= N, like ``lax.top_k``."""
    if k > p.shape[0]:
        raise ValueError(f"topk_l2: k={k} exceeds the {p.shape[0]} points")
    return stable_topk(pairwise_sq_l2(q, p), k)


def topk_l2_masked(q: torch.Tensor, p: torch.Tensor, valid: torch.Tensor,
                   k: int, lb2=None):
    """Per-query-candidate masked top-k. q: (G, D), p: (G, C, D),
    valid: (G, C) -> (sq_dists (G, k) ascending, indices (G, k) int64
    into [0, C)). Invalid rows never win; exhausted slots are (inf, -1).
    ``lb2`` is the kernel's work-skipping hint and never changes the
    result, so the plain version ignores it."""
    qf = q.float()
    pf = p.float()
    g, c = pf.shape[0], pf.shape[1]
    if c == 0:
        return (torch.full((g, k), float("inf"), device=q.device),
                torch.full((g, k), -1, dtype=torch.int64, device=q.device))
    qq = torch.sum(qf * qf, dim=1)[:, None]
    pp = torch.sum(pf * pf, dim=2)
    cross = torch.einsum("gd,gcd->gc", qf, pf)
    d = torch.clamp_min(qq + pp - 2.0 * cross, 0.0)
    d = torch.where(valid != 0, d, torch.full_like(d, float("inf")))
    kk = max(1, min(k, c))
    dd, idx = stable_topk(d, kk)
    idx = torch.where(torch.isfinite(dd), idx, torch.full_like(idx, -1))
    if kk < k:
        dd = torch.nn.functional.pad(dd, (0, k - kk), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return dd, idx


def lpgf_force(points: torch.Tensor, radius: float, g_mean: float,
               c: float = 1.1):
    """LPGF resultant force per point (paper Fig 13), exact all-pairs:
    returns (raw resultant force (N, D), total weight (N,)). Semantics of
    ``repro.kernels.ref.lpgf_force``."""
    x = points.float()
    n = x.shape[0]
    d2 = pairwise_sq_l2(x, x)
    big = torch.max(d2) + 1.0
    d2_off = d2 + big * torch.eye(n, dtype=torch.float32, device=x.device)
    d1sq = torch.min(d2_off, dim=1).values
    diff = x[None, :, :] - x[:, None, :]
    thresh_near = g_mean * torch.sqrt(d1sq)
    in_r = d2_off <= radius * radius
    near = d2_off <= thresh_near[:, None]
    far = (~near) & in_r
    zero = torch.zeros_like(d2_off)
    w_far = torch.where(far, d1sq[:, None] / torch.clamp_min(d2_off, 1e-12),
                        zero)
    w_near = torch.where(near & in_r, torch.full_like(d2_off, 1.0 / c), zero)
    w = w_far + w_near
    return torch.einsum("ij,ijd->id", w, diff), torch.sum(w, dim=1)
