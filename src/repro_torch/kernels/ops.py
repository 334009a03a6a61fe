"""Op wrappers with the reference's names and signatures
(``repro/kernels/ops.py``). Dispatch goes by the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor the hand-written kernel.
There is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_topk import topk_l2 as _topk_l2
from repro_torch.kernels.fused_topk import topk_l2_masked as _topk_l2_masked
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2 as _pairwise


def require_ieee_matmul(t: torch.Tensor) -> None:
    """An exactness-bearing fp32 product on the card must run in IEEE
    fp32: the V.R slack constants and the LPGF thresholds assume it, and
    TF32 keeps about three decimal digits."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False for exact fp32 products")


def pairwise_sq_l2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _pairwise(q.float().contiguous(), p.float().contiguous())


def pairwise_sq_l2_blocked(q: torch.Tensor, p: torch.Tensor,
                           row_block: int = 4096) -> torch.Tensor:
    """Row blocking for big M (bounds device memory)."""
    return torch.cat([pairwise_sq_l2(q[i:i + row_block], p)
                      for i in range(0, q.shape[0], row_block)])


def topk_l2(q: torch.Tensor, p: torch.Tensor, k: int):
    return _topk_l2(q.float().contiguous(), p.float().contiguous(), k)


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


def lpgf_force(points: torch.Tensor, radius: float, g_mean: float):
    if points.device.type == "cuda":
        raise NotImplementedError(
            "lpgf_force on CUDA: the port of the TPU kernel "
            "repro/kernels/lpgf_force.py::lpgf_force_pallas is queued for "
            "the next slice (LPGF takes it only for N <= 4096 points)")
    return ref.lpgf_force(points, radius, g_mean)
