"""LPGF resultant-force field: CUDA kernel wrapper.

Replaces the TPU kernel ``repro/kernels/lpgf_force.py::lpgf_force_pallas``
(bodies ``_nn_kernel`` and ``_force_kernel``); the kernels are in
``csrc/lpgf_force.cu``. At the shape the build gives it, (4096, 512),
the function needs 3*N^2*D fp32 operations on N*D floats (each squared
distance once, by the Gram matrix's symmetry, and w @ x): bound by fp32
operations outside the tensor cores (the ring thresholds assume IEEE
fp32, so no TF32). The kernel does 6*N^2*D, as the TPU kernel does: it
forms the distances in its nearest-neighbour pass and again in its force
pass, with the weights and w @ x. Each block owns 32 rows, walks every
64-point column tile through a SIMT register tile, and keeps its (32, D)
force sum in shared memory, so every sum runs in a fixed order without
atomics. A CPU tensor takes the plain version ``ref.lpgf_force``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _check, _cuda_device

launches = 0   # kernel launches since the last reset (plain calls excluded)


def lpgf_force_cuda(points: torch.Tensor, radius: float, g_mean: float,
                    c: float = 1.1):
    """points (N, D) fp32 contiguous CUDA -> (F (N, D), W (N,)) fp32."""
    global launches
    dev = _cuda_device(points)
    _check("points", points, 2, dev)
    n, d = points.shape
    f = torch.empty((n, d), dtype=torch.float32, device=dev)
    w = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        f.zero_()
        w.zero_()
        return f, w
    lib = build.library("lpgf_force")
    max_d = lib.lpgf_force_max_d()
    if d > max_d:
        raise ValueError(f"lpgf_force: D={d} exceeds the {max_d} columns "
                         f"the kernel's shared-memory accumulator holds")
    scratch = torch.empty((2 * n,), dtype=torch.float32, device=dev)
    # the reference's constants as fp32: radius^2 and 1/c formed in
    # Python floats, then rounded once
    r2 = float(np.float32(float(radius) * float(radius)))
    g = float(np.float32(g_mean))
    inv_c = float(np.float32(1.0 / c))
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.lpgf_force_launch(
        points.data_ptr(), scratch.data_ptr(), f.data_ptr(), w.data_ptr(),
        n, d, r2, g, inv_c, stream), "lpgf_force")
    launches += 1
    return f, w


def lpgf_force(points, radius: float, g_mean: float, c: float = 1.1):
    """LPGF force and total weight (semantics: ``ref.lpgf_force``)."""
    if points.device.type == "cpu":
        return ref.lpgf_force(points, radius, g_mean, c=c)
    if points.device.type != "cuda":
        raise ValueError(f"lpgf_force: unsupported device {points.device}")
    return lpgf_force_cuda(points, radius, g_mean, c=c)
