"""Mixed-precision candidate scan: CUDA kernel wrapper.

Replaces the TPU kernel ``repro/kernels/fused_topk.py::quant_lb2_pallas``
(body ``_quant_lb2_kernel``); the kernel is ``csrc/quant_lb2.cu``. It
reads each valid candidate's D int8 or bf16 codes and 12 bytes of
metadata, and a validity byte and a 4-byte output for every candidate,
so it is bound by device-memory bytes; one block streams one query's run
of 256 candidates, a warp reads whole rows coalesced (16 bytes a lane),
invalid rows are never read, and the int8 cross term accumulates exactly
in int32 (``__dp4a``). The bf16 sum runs in chains of D/32 lane-strided
products and a shuffle tree, which keeps its rounding inside the slack
(the source's header note gives the bound). The query is quantized here
by ``utils.quant.quantize_query``, as the reference quantizes it outside
its grid. A CPU tensor takes the plain version ``ref.quant_lb2``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _check, _cuda_device
from repro_torch.utils.quant import quantize_query

launches = 0   # kernel launches since the last reset (plain calls excluded)

_CODE_DTYPE = {"int8": torch.int8, "bf16": torch.bfloat16}


def quant_lb2_cuda(q: torch.Tensor, codes: torch.Tensor,
                   cscale: torch.Tensor, cppq: torch.Tensor,
                   ceps: torch.Tensor, valid: torch.Tensor, *,
                   precision: str) -> torch.Tensor:
    """q (G, D) fp32; codes (G, C, D) int8 or bf16; cscale, cppq, ceps
    (G, C) fp32; valid (G, C) bool; all contiguous CUDA -> (G, C) fp32
    widened squared lower bounds, +inf where invalid."""
    global launches
    dev = _cuda_device(q)
    _check("q", q, 2, dev)
    want = _CODE_DTYPE.get(precision)
    if want is None:
        raise ValueError(f"quant_lb2: precision must be 'int8' or 'bf16', "
                         f"got {precision!r}")
    g, d = q.shape
    if codes.device != dev or codes.dtype != want or codes.dim() != 3 \
            or codes.shape[0] != g or codes.shape[2] != d \
            or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous (G, C, D) = "
                         f"({g}, C, {d}) {want} tensor on {dev}, got "
                         f"{tuple(codes.shape)} {codes.dtype} on "
                         f"{codes.device}")
    c = codes.shape[1]
    for name, t in (("cscale", cscale), ("cppq", cppq), ("ceps", ceps)):
        _check(name, t, 2, dev)
        if t.shape != (g, c):
            raise ValueError(f"{name} {tuple(t.shape)} != {(g, c)}")
    if valid.device != dev or valid.dtype != torch.bool \
            or valid.shape != (g, c) or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous (G, C) bool tensor on "
                         "q's device")
    out = torch.empty((g, c), dtype=torch.float32, device=dev)
    if g == 0 or c == 0:
        return out
    qc, qscale, qqq, qeps = (t.contiguous()
                             for t in quantize_query(q, precision))
    lib = build.library("quant_lb2")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.quant_lb2_launch(
        qc.data_ptr(), qscale.data_ptr(), qqq.data_ptr(), qeps.data_ptr(),
        codes.data_ptr(), cscale.data_ptr(), cppq.data_ptr(),
        ceps.data_ptr(), valid.data_ptr(), out.data_ptr(), g, c, d,
        int(precision == "int8"), stream), "quant_lb2")
    launches += 1
    return out


def quant_lb2(q, codes, cscale, cppq, ceps, valid, *, precision: str):
    """Widened squared lower bounds (semantics: ``ref.quant_lb2``)."""
    if q.device.type == "cpu":
        return ref.quant_lb2(q, codes, cscale, cppq, ceps, valid,
                             precision=precision)
    if q.device.type != "cuda":
        raise ValueError(f"quant_lb2: unsupported device {q.device}")
    return quant_lb2_cuda(q, codes, cscale, cppq, ceps, valid,
                          precision=precision)
