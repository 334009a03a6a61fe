"""LPGF resultant-force field: CUDA kernel wrapper.

Replaces the TPU kernel ``repro/kernels/lpgf_force.py::lpgf_force_pallas``
(bodies ``_nn_kernel`` and ``_force_kernel``); the kernels are in
``csrc/lpgf_force.cu``. At the shape the build gives it, (4096, 512),
the function needs 3*N^2*D fp32 operations on N*D floats (each squared
distance once, by the Gram matrix's symmetry, and w @ x): bound by fp32
operations outside the tensor cores (the ring thresholds assume IEEE
fp32, so no TF32). The kernels do that work on the shared distance tile
of ``csrc/l2_tile.cuh``: the upper-triangle tiles of the distances,
stored with their mirror into an (N, N) scratch beside per-tile row
minima; then the weights in place of the distances, one block per row;
then w @ x as the same tile over (w, x^T). Every sum runs in a fixed
order without atomics, so two calls give the same bits. The scratch
(N^2 + N*ceil(N/128) + D*N floats, about 72.5 MiB at (4096, 512)) comes
from torch's caching allocator; there is no limit on N or D below the
card's memory. A CPU tensor takes the plain version ``ref.lpgf_force``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _check, _cuda_device

launches = 0   # kernel launches since the last reset (plain calls excluded)
TILE = 128     # rows and points a distance tile (l2tile::BM = BN)


def lpgf_force_cuda(points: torch.Tensor, radius: float, g_mean: float,
                    c: float = 1.1):
    """points (N, D) fp32 contiguous CUDA -> (F (N, D), W (N,)) fp32."""
    f, w, _ = _launch(points, radius, g_mean, c)
    return f, w


def _launch(points: torch.Tensor, radius: float, g_mean: float,
            c: float = 1.1, keep: bool = False):
    """Launch the kernels; returns (F, W, scratch). With ``keep`` the
    weights go to a buffer of their own, so the stored squared distances
    survive, and scratch is {"d2": (N, N), "w": (N, N), "pmin": (N,
    ceil(N/128)) per-tile row minima, "xt": (D, N)}; else None (the tests
    read the scratch; the force field itself is the same either way)."""
    global launches
    dev = _cuda_device(points)
    _check("points", points, 2, dev)
    n, d = points.shape
    f = torch.empty((n, d), dtype=torch.float32, device=dev)
    w = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        f.zero_()
        w.zero_()
        return f, w, None
    lib = build.library("lpgf_force")
    d2 = torch.empty((n, n), dtype=torch.float32, device=dev)
    wts = torch.empty_like(d2) if keep else d2
    pmin = torch.empty((n, -(-n // TILE)), dtype=torch.float32, device=dev)
    xt = torch.empty((d, n), dtype=torch.float32, device=dev)
    # the reference's constants as fp32: radius^2 and 1/c formed in
    # Python floats, then rounded once
    r2 = float(np.float32(float(radius) * float(radius)))
    g = float(np.float32(g_mean))
    inv_c = float(np.float32(1.0 / c))
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.lpgf_force_launch(
        points.data_ptr(), d2.data_ptr(), wts.data_ptr(), pmin.data_ptr(),
        xt.data_ptr(), f.data_ptr(), w.data_ptr(), n, d, r2, g, inv_c,
        stream), "lpgf_force")
    launches += 1
    scratch = dict(d2=d2, w=wts, pmin=pmin, xt=xt) if keep else None
    return f, w, scratch


def lpgf_force(points, radius: float, g_mean: float, c: float = 1.1):
    """LPGF force and total weight (semantics: ``ref.lpgf_force``)."""
    if points.device.type == "cpu":
        return ref.lpgf_force(points, radius, g_mean, c=c)
    if points.device.type != "cuda":
        raise ValueError(f"lpgf_force: unsupported device {points.device}")
    return lpgf_force_cuda(points, radius, g_mean, c=c)
