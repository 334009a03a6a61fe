"""Op wrappers with the reference's names and signatures
(``repro/kernels/ops.py``). Dispatch goes by the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor the hand-written kernel.
There is no fallback from one to the other."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import counted
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.fused_topk import topk_l2 as _topk_l2
from repro_torch.kernels.fused_topk import topk_l2_masked as _topk_l2_masked
from repro_torch.kernels.lpgf_force import lpgf_force as _lpgf_force
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2 as _pairwise
from repro_torch.kernels.quant_lb2 import quant_lb2 as _quant_lb2
from repro_torch.kernels.ref import stable_topk


def require_ieee_matmul(t: torch.Tensor) -> None:
    """An exactness-bearing fp32 product on the card must run in IEEE
    fp32: the V.R slack constants and the LPGF thresholds assume it, and
    TF32 keeps about three decimal digits."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False for exact fp32 products")


@counted
def pairwise_sq_l2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _pairwise(q.float().contiguous(), p.float().contiguous())


def pairwise_sq_l2_blocked(q: torch.Tensor, p: torch.Tensor,
                           row_block: int = 4096) -> torch.Tensor:
    """Row blocking for big M (bounds device memory)."""
    return torch.cat([pairwise_sq_l2(q[i:i + row_block], p)
                      for i in range(0, q.shape[0], row_block)])


@counted
def topk_l2(q: torch.Tensor, p: torch.Tensor, k: int):
    return _topk_l2(q.float().contiguous(), p.float().contiguous(), k)


@counted
def topk_l2_masked(q: torch.Tensor, p: torch.Tensor, valid: torch.Tensor,
                   k: int, lb2=None):
    """Per-query candidate tiles + validity mask (hybrid-engine leaf
    scan). ``lb2`` (optional (G, C) squared lower bounds) lets the kernel
    skip chunks; it never changes results."""
    return _topk_l2_masked(
        q.float().contiguous(), p.float().contiguous(),
        valid.bool().contiguous(), k,
        lb2=None if lb2 is None else lb2.float().contiguous())


def topk_l2_blocked(q: torch.Tensor, p: torch.Tensor, k: int,
                    row_block: int = 2048):
    ds, is_ = [], []
    for i in range(0, q.shape[0], row_block):
        d, ix = topk_l2(q[i:i + row_block], p, k)
        ds.append(d)
        is_.append(ix)
    return torch.cat(ds), torch.cat(is_)


def _ceil_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@counted
def quant_lb2(q, codes, cscale, cppq, ceps, valid, *, precision: str):
    """Widened squared lower bounds from a reduced-precision candidate
    scan (semantics: ``ref.quant_lb2``; conservative-bound contract: for
    every valid candidate the result is <= the true squared distance)."""
    return _quant_lb2(q.float().contiguous(), codes.contiguous(),
                      cscale.float().contiguous(), cppq.float().contiguous(),
                      ceps.float().contiguous(), valid.bool().contiguous(),
                      precision=precision)


def topk_l2_masked_mp(q, sel, valid, data_tiles, pdata, pscale, pppq, peps,
                      k: int, lb2=None, kth0=None, *, precision: str,
                      k_rescue: Optional[int] = None,
                      host_exit: bool = True):
    """Mixed-precision leaf scan with exact fp32 rescue (semantics of
    ``repro.kernels.ops.topk_l2_masked_mp``).

    Takes the per-round tile selection ``sel`` (G, W) plus the FULL
    per-layout arrays, so the wide gather runs on the narrow codes:
    ``data_tiles`` (T, cap, D) fp32 and ``pdata``/``pscale``/``pppq``/
    ``peps``, the layout's ``utils.quant.plan_tiles`` planes. Candidate c
    of query g is slot ``c % cap`` of tile ``sel[g, c // cap]``.

      1. reduced-precision scan -> widened squared lower bounds
         (``quant_lb2``), tightened by the caller's ball bounds ``lb2``;
      2. iterative fp32 rescue: rescore the R lowest-bound unrescued
         candidates in fp32, tightening the running kth; a candidate
         whose bound exceeds ``min(kth0, running kth)`` STRICTLY is
         refuted. The reference's ``lax.while_loop`` is a host loop here
         that reads the (G,) "any live" flag once per iteration, with the
         same R and iteration budget, and picks through ``stable_topk``,
         so the rescued set is the reference's. ``host_exit=False`` skips
         that read and runs the whole budget (an iteration with nothing
         live changes nothing), so the call takes no host sync;
      3. stable top-k over the rescued distances in candidate order.

    ``k`` is the output width; ``k_rescue`` (default k, at most k) is the
    rank whose running distance refutes, and sets R — the engine ranks
    k plus a re-rank margin while refuting at the stopping rank, so its
    rescue work is the reference's. Rows past ``k_rescue`` come from the
    rescued candidates only.

    Returns (d2 (G, k) ascending, idx (G, k) into [0, W*cap), rescued
    (G,) int64 — per-query fp32-rescored candidate counts — and
    refuted_lb (G, 2) fp32: the least bound among the valid candidates
    the rescue refuted, +inf where it refuted none, split by source.
    Column 0 holds the candidates whose bound is ``quant_lb2``'s own, a
    lower bound on the exact squared distance up to the rounding of its
    final square; column 1 those whose ball bound ``lb2`` was larger,
    which carries that bound's own rounding errors.)"""
    g, w = sel.shape
    _, cap, d = data_tiles.shape
    c = w * cap
    kr = k if k_rescue is None else min(k_rescue, k)
    kk = max(1, min(k, c))
    kkr = max(1, min(kr, c))
    dev = q.device
    qf = q.float()
    inf = float("inf")
    codes = pdata[sel].reshape(g, c, d)
    cscale = pscale[sel].repeat_interleave(cap, dim=1)
    cppq = pppq[sel].reshape(g, c)
    ceps = peps[sel].repeat_interleave(cap, dim=1)
    lb2q = quant_lb2(qf, codes, cscale, cppq, ceps, valid,
                     precision=precision)
    from_ball = torch.zeros_like(valid, dtype=torch.bool)
    if lb2 is not None:
        from_ball = lb2.float() > lb2q
        lb2q = torch.maximum(lb2q, lb2.float())
    qq = torch.sum(qf * qf, dim=1)[:, None]
    kvec = kth0.float() if kth0 is not None else \
        torch.full((g,), inf, device=dev)
    vmask = valid.bool()
    r = min(c, max(32, _ceil_pow2(2 * kr)))
    budget = c // r + (1 if c % r else 0) + 1
    d2full = torch.full((g, c), inf, device=dev)
    bd = torch.full((g, kkr), inf, device=dev)
    for _ in range(budget):
        thresh = torch.minimum(kvec, bd[:, -1])
        live = vmask & torch.isinf(d2full) & (lb2q <= thresh[:, None])
        if host_exit and not bool(live.any()):
            break
        key = torch.where(live, lb2q, torch.full_like(lb2q, inf))
        kv, pick = stable_topk(key, r)             # R lowest bounds
        pv = torch.isfinite(kv)                    # real (live) picks
        tile = torch.gather(sel, 1, torch.div(pick, cap,
                                              rounding_mode="floor"))
        pts = data_tiles[tile, pick % cap]         # (G, R, D) fp32
        pp = torch.sum(pts * pts, dim=2)
        require_ieee_matmul(pts)
        cross = torch.einsum("gd,grd->gr", qf, pts)
        d2 = torch.clamp_min(qq + pp - 2.0 * cross, 0.0)
        d2 = torch.where(pv, d2, torch.full_like(d2, inf))
        d2full.scatter_(1, pick, torch.minimum(d2full.gather(1, pick), d2))
        bd = torch.topk(torch.cat([bd, d2], dim=1), kkr, dim=1,
                        largest=False, sorted=True).values
    done = vmask & torch.isfinite(d2full)
    rescued = done.sum(1)
    refuted = vmask & ~done
    refuted_lb = torch.stack(
        [torch.where(refuted & src, lb2q, torch.full_like(lb2q, inf)).amin(1)
         for src in (~from_ball, from_ball)], dim=1)
    dfin = torch.where(done, d2full, torch.full_like(d2full, inf))
    dd, idx = stable_topk(dfin, kk)
    idx = torch.where(torch.isfinite(dd), idx, torch.full_like(idx, -1))
    if kk < k:
        dd = torch.nn.functional.pad(dd, (0, k - kk), value=inf)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return dd, idx, rescued, refuted_lb


@counted
def lpgf_force(points: torch.Tensor, radius: float, g_mean: float):
    """LPGF force field and total weights: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return _lpgf_force(points.float().contiguous(), radius, g_mean)


@counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Online-softmax attention over (B, S, H, hd) with expanded kv heads
    (semantics: ``ref.flash_attention``): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return _flash_attention(q, k, v, causal=causal, window=window)
