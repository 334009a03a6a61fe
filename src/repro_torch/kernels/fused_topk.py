"""Fused distance + running top-k: CUDA kernel wrappers.

Replaces the TPU kernels ``repro/kernels/fused_topk.py::
topk_l2_masked_pallas`` (body ``_masked_kernel``) and ``topk_l2_pallas``
(body ``_kernel``); both live in ``csrc/fused_topk.cu``.

* ``topk_l2_masked`` is the engine's beam-round kernel: per-query
  candidate tiles, so it reads G*C*D*4 bytes for G*C*D*2 operations and
  is bound by device-memory bytes (a batched GEMV). One block per query
  keeps q in shared memory, warps read whole candidate rows coalesced,
  masked candidates are never read, and chunks whose valid candidates'
  ``lb2`` bounds are all at or above the running kth are skipped.
* ``topk_l2`` ranks one shared point set for every query (LPGF's mean
  nearest-neighbour distance): 2*M*N*D operations on (M + N)*D floats,
  bound by fp32 operations. It forms its distances with the tile
  ``pairwise_sq_l2`` uses (``csrc/l2_tile.cuh``: 128 x 128 pairs a
  block), so they equal that kernel's bit for bit, and cuts N into
  ``splits`` runs of column tiles so that (row tiles x splits) blocks
  fill the card; each block leaves its split's k best keys per row in
  an (M, splits, k) scratch, and a second kernel merges the splits. Two
  routes, by ``route(k)`` alone: ``"reg"`` (k <= ``REG_K``) keeps the
  running top-k in registers, ``"merge"`` (any k) rank-merges each
  tile's keys into a sorted running buffer in the scratch.

Both rank packed (distance bits, index) keys, so ties keep the lower
index (the ``lax.top_k`` law the engine's "carry first" merge relies
on) at any k and in any split or merge order. ``topk_l2_masked``'s
running buffer lives in shared memory while it fits there, and above
that in a global scratch this wrapper allocates (the library's
``topk_l2_masked_scratch_bytes`` says how much). A CPU tensor takes the
plain version in ``ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _check, _cuda_device

# kernel launches since the last reset (plain calls excluded); topk_l2's
# by route, and ``topk_l2_launches`` reads their total
topk_l2_launches_by_route = {"reg": 0, "merge": 0}
topk_l2_masked_launches = 0

REG_K = 2        # the register route's largest k (kRegK in the source)
TILE_N = 128     # points a column tile (l2tile::BN)


def __getattr__(name: str):
    if name == "topk_l2_launches":
        return sum(topk_l2_launches_by_route.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    global topk_l2_masked_launches
    for r in topk_l2_launches_by_route:
        topk_l2_launches_by_route[r] = 0
    topk_l2_masked_launches = 0


def route(k: int) -> str:
    """The ``topk_l2`` kernel route a k takes: ``"reg"`` for k <=
    ``REG_K``, ``"merge"`` above."""
    return "reg" if k <= REG_K else "merge"


def split_bounds(n: int, splits: int):
    """The point ranges [begin, end) of the ``splits`` runs ``topk_l2``
    cuts n points into: ceil(n / TILE_N) column tiles, split s taking
    tiles [s * T // splits, (s + 1) * T // splits)."""
    t = -(-n // TILE_N)
    return [(s * t // splits * TILE_N, min((s + 1) * t // splits * TILE_N, n))
            for s in range(splits)]


def _need_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"fused top-k kernels need k >= 1, got k={k}")


def _scratch(nbytes: int, dev):
    """The running buffers' global scratch: None while they fit in
    shared memory (the library reports 0 bytes)."""
    return torch.empty(nbytes, dtype=torch.uint8, device=dev) \
        if nbytes else None


def topk_l2_masked_cuda(q: torch.Tensor, p: torch.Tensor,
                        valid: torch.Tensor, k: int,
                        lb2: Optional[torch.Tensor] = None):
    """q (G, D), p (G, C, D) fp32; valid (G, C) bool; lb2 (G, C) fp32 or
    None; all contiguous CUDA -> ((G, k) fp32, (G, k) int64)."""
    global topk_l2_masked_launches
    dev = _cuda_device(q)
    _check("q", q, 2, dev)
    _check("p", p, 3, dev)
    g, d = q.shape
    c = p.shape[1]
    if p.shape[0] != g or p.shape[2] != d:
        raise ValueError(f"p {tuple(p.shape)} does not match q {(g, d)}")
    if valid.device != dev or valid.dtype != torch.bool \
            or valid.shape != (g, c) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (G, C) bool tensor on "
                         "q's device")
    if lb2 is not None:
        _check("lb2", lb2, 2, dev)
        if lb2.shape != (g, c):
            raise ValueError(f"lb2 {tuple(lb2.shape)} != {(g, c)}")
    _need_k(k)
    lib = build.library("fused_topk")
    kk = max(1, min(k, c))
    outd = torch.empty((g, kk), dtype=torch.float32, device=dev)
    outi = torch.empty((g, kk), dtype=torch.int64, device=dev)
    if g and c:
        scratch = _scratch(lib.topk_l2_masked_scratch_bytes(g, d, kk), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.topk_l2_masked_launch(
            q.data_ptr(), p.data_ptr(), valid.data_ptr(),
            None if lb2 is None else lb2.data_ptr(), outd.data_ptr(),
            outi.data_ptr(), None if scratch is None else scratch.data_ptr(),
            g, c, d, kk, stream), "topk_l2_masked")
        topk_l2_masked_launches += 1
    else:
        outd.fill_(float("inf"))
        outi.fill_(-1)
    if kk < k:  # fewer candidates than k: pad to the requested width
        outd = torch.nn.functional.pad(outd, (0, k - kk), value=float("inf"))
        outi = torch.nn.functional.pad(outi, (0, k - kk), value=-1)
    return outd, outi


def topk_l2_cuda(q: torch.Tensor, p: torch.Tensor, k: int):
    """q (M, D), p (N, D) fp32 contiguous CUDA -> ((M, k) fp32 ascending,
    (M, k) int64), on the kernel route ``route(k)``. Requires k <= N."""
    return _launch(q, p, k, route(k))


def _launch(q: torch.Tensor, p: torch.Tensor, k: int, path: str,
            splits: Optional[int] = None):
    """``topk_l2_cuda`` on the ``path`` route, over ``splits`` runs of N
    (None: the library's choice for this shape). Named directly only to
    hold the routes and the split merge to each other at one input;
    ``"reg"`` takes only k <= ``REG_K``."""
    dev = _cuda_device(q)
    _check("q", q, 2, dev)
    _check("p", p, 2, dev)
    m, d = q.shape
    n = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"q and p widths differ: {d} vs {p.shape[1]}")
    _need_k(k)
    if k > n:
        raise ValueError(f"topk_l2: k={k} exceeds the {n} points")
    if path not in topk_l2_launches_by_route or (path == "reg"
                                                 and k > REG_K):
        raise ValueError(f"topk_l2: no {path!r} route at k={k}")
    lib = build.library("fused_topk")
    outd = torch.empty((m, k), dtype=torch.float32, device=dev)
    outi = torch.empty((m, k), dtype=torch.int64, device=dev)
    if m:
        reg = int(path == "reg")
        if splits is None:
            splits = lib.topk_l2_splits(m, n, k, reg)
        if not 1 <= splits <= -(-n // TILE_N):
            raise ValueError(f"topk_l2: {splits} splits of {n} points")
        scratch = torch.empty(lib.topk_l2_scratch_bytes(m, k, splits, reg),
                              dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.topk_l2_launch(
            q.data_ptr(), p.data_ptr(), scratch.data_ptr(), m, n, d, k,
            splits, reg, stream), "topk_l2")
        build.check(lib.topk_l2_merge_launch(
            scratch.data_ptr(), outd.data_ptr(), outi.data_ptr(), m, k,
            splits, stream), "topk_l2 (split merge)")
        topk_l2_launches_by_route[path] += 1
    return outd, outi


def topk_l2_masked(q, p, valid, k: int, lb2=None):
    """Per-query masked top-k (semantics: ``ref.topk_l2_masked``)."""
    if q.device.type == "cpu":
        return ref.topk_l2_masked(q, p, valid, k, lb2=lb2)
    if q.device.type != "cuda":
        raise ValueError(f"topk_l2_masked: unsupported device {q.device}")
    return topk_l2_masked_cuda(q, p, valid, k, lb2=lb2)


def topk_l2(q, p, k: int):
    """Shared-point-set top-k (semantics: ``ref.topk_l2``)."""
    if q.device.type == "cpu":
        return ref.topk_l2(q, p, k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_l2: unsupported device {q.device}")
    return topk_l2_cuda(q, p, k)
