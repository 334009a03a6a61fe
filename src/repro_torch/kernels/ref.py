"""Plain PyTorch versions of the kernels: they define the semantics.

Counterparts of ``repro/kernels/ref.py``. The CPU tests hold them to the
JAX functions; ``chip_smoke.py`` holds each CUDA kernel to them on the
card. A wrapper runs them for a tensor that lies on the CPU.

Tie law: ``lax.top_k`` is stable (among equal values the lower index
wins) and ``torch.topk`` promises no tie order, so every top-k here goes
through ``stable_topk``, which ranks packed (distance, index) keys.
"""
from __future__ import annotations

import math

import torch


def stable_topk(d: torch.Tensor, k: int):
    """The k smallest entries of each row of ``d`` (non-negative fp32,
    +inf or NaN), ascending; equal values order by the lower column, and
    NaN ranks after +inf (as ``lax.top_k`` of the negated distances ranks
    a row with a NaN coordinate: last).

    The fp32 bit pattern of a non-negative float is order-preserving as
    an integer, so (bits << 32) | column is a unique int64 key whose
    order is the (value, column) order: one ``torch.topk`` over the keys
    has no ties left to break. Every NaN keys as the positive quiet NaN
    0x7fc00000, which lies above +inf's 0x7f800000."""
    d = d.float().contiguous() + 0.0          # -0.0 -> +0.0: one key for 0
    n = d.shape[-1]
    bits = d.view(torch.int32).to(torch.int64)
    bits = torch.where(torch.isnan(d), 0x7FC00000, bits)
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


def quant_lb2(q: torch.Tensor, codes: torch.Tensor, cscale: torch.Tensor,
              cppq: torch.Tensor, ceps: torch.Tensor, valid: torch.Tensor, *,
              precision: str) -> torch.Tensor:
    """Widened squared LOWER bounds from a reduced-precision scan
    (semantics of ``repro.kernels.ref.quant_lb2``).

    Contract (what the mixed-precision path's exactness rests on): for
    every valid candidate,  lb2[g, c] <= ||q_g - p_c||^2  — the bound may
    be arbitrarily loose (that only costs rescue work), never violated.
    Invalid candidates get +inf.

    q: (G, D) fp32 raw queries. codes: (G, C, D) int8 codes or bf16
    values; cscale/cppq/ceps (G, C) fp32: tile scale, EXACT squared norm
    of the dequantized candidate, and per-row L2 quantization error
    bound. Dequantize both sides, take the quadratic-expansion distance
    d̂ between the dequantized vectors, then by the triangle inequality
    ||q - p|| >= d̂ - eps_q - eps_p, minus an fp slack for the fp32
    rounding of the expansion itself. The operations run in the
    reference's order, so int8 bounds (whose cross term is an exact
    integer sum) agree with it bit for bit."""
    from repro_torch.utils.quant import (SLACK_ABS, SLACK_MAG, SLACK_REL,
                                         quantize_query, sqrt_rn)
    qcast, qscale, qqq, qeps = quantize_query(q, precision)
    cf = codes.float()
    qf = qcast.float()
    cross = torch.einsum("gd,gcd->gc", qf, cf)
    if precision == "int8":
        d2h = qqq[:, None] + cppq - (2.0 * qscale[:, None] * cscale) * cross
    else:
        d2h = qqq[:, None] + cppq - 2.0 * cross
    d2h = torch.clamp_min(d2h, 0.0)
    dhat = sqrt_rn(d2h)
    mag = torch.clamp_min(qqq[:, None] + cppq, 0.0)
    slack = SLACK_ABS + SLACK_REL * dhat + SLACK_MAG * sqrt_rn(mag)
    lbr = torch.clamp_min(dhat - (qeps[:, None] + ceps) - slack, 0.0)
    return torch.where(valid != 0, lbr * lbr,
                       torch.full_like(lbr, float("inf")))


def lpgf_weights(d2: torch.Tensor, radius: float, g_mean: float,
                 c: float = 1.1):
    """The LPGF force law's weights from all squared distances d2 (N, N):
    returns (w (N, N), d1 (N,)), d1 the squared nearest-neighbour
    distance. Self pairs are excluded by index, as
    ``repro.kernels.lpgf_force._nn_kernel`` and ``_force_kernel`` do."""
    from repro_torch.utils.quant import sqrt_rn
    n = d2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2_off = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    d1sq = torch.min(d2_off, dim=1).values
    thresh_near = g_mean * sqrt_rn(d1sq)
    in_r = d2_off <= radius * radius
    near = d2_off <= thresh_near[:, None]
    far = (~near) & in_r
    zero = torch.zeros_like(d2_off)
    w_far = torch.where(far, d1sq[:, None] / torch.clamp_min(d2_off, 1e-12),
                        zero)
    w_near = torch.where(near & in_r, torch.full_like(d2_off, 1.0 / c), zero)
    return w_far + w_near, d1sq


def lpgf_force(points: torch.Tensor, radius: float, g_mean: float,
               c: float = 1.1, row_block: int = 256, d2=None):
    """LPGF resultant force per point (paper Fig 13), exact all-pairs:
    returns (raw resultant force (N, D), total weight (N,)). Semantics of
    ``repro.kernels.lpgf_force.lpgf_force_pallas``, the kernel the
    reference runs: self pairs are excluded by index. (The reference's
    ``ref.lpgf_force`` adds max(d2) + 1 to the diagonal instead, which
    differs only when that still lies within the radius.) The force sum
    runs over ``row_block`` rows at a time to bound the (rows, N, D)
    difference tensor. ``d2`` gives the squared distances to use instead
    of ``pairwise_sq_l2(points, points)`` (the card tests feed the
    kernel's own)."""
    x = points.float()
    n = x.shape[0]
    if d2 is None:
        d2 = pairwise_sq_l2(x, x)
    w, _ = lpgf_weights(d2, radius, g_mean, c)
    f = torch.cat([
        torch.einsum("ij,ijd->id", w[i:i + row_block],
                     x[None, :, :] - x[i:i + row_block, None, :])
        for i in range(0, n, row_block)]) if n else torch.zeros_like(x)
    return f, torch.sum(w, dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention over (B, S, H, hd) q, k, v with the same H (GQA heads are
    expanded by the caller), semantics of ``repro.kernels.ref.
    flash_attention``: fp32 scores divided by sqrt(hd), masked scores set
    to -1e30 (causal: key <= query; window: key > query - window, by
    absolute position), an fp32 softmax over the keys, fp32 weights times
    V, and the output cast to q's dtype. Returns (B, S, H, hd).
    ``q_offset``: q holds the queries at positions q_offset onwards (a
    block of a longer prompt's queries, against all its keys)."""
    hd = q.shape[-1]
    s, skv = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    qpos = torch.arange(q_offset, q_offset + s, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)
