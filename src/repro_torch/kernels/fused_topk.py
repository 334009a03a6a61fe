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
  bound by fp32 operations; a block of 16 queries shares each staged
  point chunk so the set is read M/16 times, not M times.

Both keep a sorted running buffer of packed (distance, index) keys, so
ties keep the lower index (the ``lax.top_k`` law the engine's "carry
first" merge relies on), at any k: the buffer lives in shared memory
while it fits there, and above that in a global scratch this wrapper
allocates (the library's ``*_scratch_bytes`` says how much). A CPU tensor
takes the plain version in ``ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _check, _cuda_device

topk_l2_launches = 0
topk_l2_masked_launches = 0


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
    (M, k) int64). Requires k <= N."""
    global topk_l2_launches
    dev = _cuda_device(q)
    _check("q", q, 2, dev)
    _check("p", p, 2, dev)
    m, d = q.shape
    n = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"q and p widths differ: {d} vs {p.shape[1]}")
    _need_k(k)
    lib = build.library("fused_topk")
    if k > n:
        raise ValueError(f"topk_l2: k={k} exceeds the {n} points")
    outd = torch.empty((m, k), dtype=torch.float32, device=dev)
    outi = torch.empty((m, k), dtype=torch.int64, device=dev)
    if m:
        scratch = _scratch(lib.topk_l2_scratch_bytes(m, k), dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.topk_l2_launch(
            q.data_ptr(), p.data_ptr(), outd.data_ptr(), outi.data_ptr(),
            None if scratch is None else scratch.data_ptr(), m, n, d, k,
            stream), "topk_l2")
        topk_l2_launches += 1
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
