"""Blocked pairwise squared-L2 distances: CUDA kernel wrapper.

Replaces the TPU kernel ``repro/kernels/pairwise_l2.py::
pairwise_sq_l2_pallas`` (body ``_kernel``). The kernel,
``csrc/pairwise_l2.cu``, is the shared IEEE-fp32 distance tile of
``csrc/l2_tile.cuh`` (128 x 128 outputs a block, 8 x 8 register
micro-tiles, three ``cp.async`` stages of 32-wide D slices, persistent
blocks) with a store epilogue that fuses the row norms and the
``max(0, .)`` clamp. At the main path's shapes it does 2*M*N*D fp32
operations on (M + N)*D + M*N floats, so it is bound by fp32 operations
outside the tensor cores (TF32 would break the V.R slack constants' IEEE
fp32 assumption). Norms and products are one fmaf chain each over D in
the same order, so a row against itself is exactly 0 (LPGF masks self
pairs by that). A CPU tensor takes the plain version
``ref.pairwise_sq_l2``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0   # kernel launches since the last reset (plain calls excluded)


def _cuda_device(q: torch.Tensor) -> torch.device:
    """The device a ``*_cuda`` wrapper launches on: q's, which must be a
    CUDA device (a CPU tensor would hand host pointers to the kernel)."""
    if not q.is_cuda:
        raise ValueError(f"q is on {q.device}: the CUDA kernels take CUDA "
                         f"tensors")
    return q.device


def _check(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pairwise_sq_l2_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """q (M, D), p (N, D) fp32 contiguous CUDA -> (M, N) fp32."""
    global launches
    dev = _cuda_device(q)
    _check("q", q, 2, dev)
    _check("p", p, 2, dev)
    m, d = q.shape
    n = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"q and p widths differ: {d} vs {p.shape[1]}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = build.library("pairwise_l2")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.pairwise_sq_l2_launch(
        q.data_ptr(), p.data_ptr(), out.data_ptr(), m, n, d, stream),
        "pairwise_sq_l2")
    launches += 1
    return out


def pairwise_sq_l2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, (M, D) x (N, D) -> (M, N) fp32: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return ref.pairwise_sq_l2(q, p)
    if q.device.type != "cuda":
        raise ValueError(f"pairwise_sq_l2: unsupported device {q.device}")
    return pairwise_sq_l2_cuda(q, p)
