"""Shared quantization helpers (port of ``repro/utils/quant.py``).

Two consumers, one module:

  * ``quantize_i8``/``dequantize_i8`` — per-channel (last-dim) symmetric
    int8 codes for the optimizer state (``train/optimizer.py``). Codes
    keep the tensor's own shape, scales are ``shape[:-1] + (1,)``.
  * ``plan_tiles`` — per-tile planes for the mixed-precision tile scan.

``plan_tiles`` turns one (T, cap, d) fp32 tile layout into per-TILE
symmetric planes: the narrow codes, one scale per tile, the exact squared
norms of the dequantized rows and the analytic per-row L2 quantization
error bound. The bound is what makes the reduced-precision scan a valid
*lower* bound on the true distance (see ``kernels/ref.quant_lb2``): for
any row x and its dequantized value x̂, ||x - x̂|| <= eps, hence by the
triangle inequality ||q - x|| >= ||q̂ - x̂|| - eps_q - eps_x.

Error bounds (worst case, not expected case — exactness depends on them):

  int8: scale s = max|x| / 127 (floored), element error <= s/2 after
  round-to-nearest (the floor never causes clipping: if the floor binds,
  |x|/s <= 127 already), so row L2 error <= (s/2) * sqrt(d).

  bf16: 8 effective mantissa bits, relative element error <= 2^-8, so
  row L2 error <= 2^-8 * ||x|| — per tile we keep the max row norm.

The planes equal the reference's bit for bit: the host arithmetic is the
reference's numpy, and the one cast numpy cannot do, fp32 -> bf16, is
torch's, which rounds to nearest even as ml_dtypes does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

PRECISIONS = ("fp32", "bf16", "int8")

# scale floors: a tile/channel of exact zeros still needs a positive
# scale (codes 0, dequantized 0 — round trip exact, no division by zero)
SCALE_FLOOR = 1e-12       # optimizer per-channel floor (the reference's)
TILE_SCALE_FLOOR = 1e-8   # tile-plane + query floor
BF16_EPS = 2.0 ** -8      # bf16 relative rounding bound per element

# conservative fp slack added on top of the quantization bound when the
# widened lower bound is formed (shared by kernels/ref.py and the CUDA
# kernel, csrc/quant_lb2.cu): an absolute + distance-relative term plus a
# magnitude term covering the quadratic expansion's cancellation error
SLACK_ABS = 1e-4
SLACK_REL = 1e-4
SLACK_MAG = 2e-3


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (IEEE ``sqrtf``, as XLA and
    CUDA compute it). torch's vectorized CPU ``sqrt`` is not always
    correctly rounded; the square root of the value in fp64, rounded once
    to fp32, is."""
    return torch.sqrt(x.double()).float()


# ---------------------------------------------------------------------------
# Per-channel (last-dim) int8 quantization — optimizer state encoding
# ---------------------------------------------------------------------------
def quantize_i8(x: torch.Tensor):
    """x -> (int8 codes of x's shape, fp32 per-channel scales
    ``shape[:-1] + (1,)``): scale = max|x| / 127 over the last axis,
    floored at ``SCALE_FLOOR``, codes round half to even (as
    ``jnp.round``) and clipped to [-127, 127]."""
    x = x.float()
    scale = torch.clamp_min(div(x.abs().amax(dim=-1, keepdim=True), 127.0),
                            SCALE_FLOOR)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded once on every device: torch's CUDA division by a
    Python scalar is a product with the scalar's rounded reciprocal,
    which can land an ulp from the quotient (71,199 of 2^20 Gaussian
    values on an H100); a divisor tensor on x's device is divided."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def dequantize_i8(codes: torch.Tensor, scale: torch.Tensor, shape=None
                  ) -> torch.Tensor:
    return codes.float() * scale


class TilePlanes(NamedTuple):
    """One layout's reduced-precision scan operands (CPU tensors from
    ``plan_tiles``; the engine moves them to its device once)."""
    data: torch.Tensor    # (T, cap, d) int8 codes or bf16 values
    scale: torch.Tensor   # (T,)  fp32 per-tile symmetric scale (ones: bf16)
    ppq: torch.Tensor     # (T, cap) fp32 EXACT squared norms of deq rows
    eps: torch.Tensor     # (T,)  fp32 per-row L2 quantization error bound


def _planes(*arrays) -> TilePlanes:
    return TilePlanes(*(a if isinstance(a, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(a))
                        for a in arrays))


def quantize_tiles_i8(tiles, valid) -> TilePlanes:
    """(T, cap, d) fp32 tiles -> int8 planes, one symmetric scale per
    tile over its valid rows (invalid slots are zeroed first so bucket
    padding never inflates a scale)."""
    t = np.asarray(tiles, np.float32)
    v = np.asarray(valid, bool)
    tz = np.where(v[:, :, None], t, 0.0)
    amax = np.abs(tz).max(axis=(1, 2)) if t.size else \
        np.zeros(t.shape[0], np.float32)
    scale = np.maximum(amax / 127.0, TILE_SCALE_FLOOR).astype(np.float32)
    codes = np.clip(np.rint(tz / scale[:, None, None]), -127, 127
                    ).astype(np.int8)
    deq = codes.astype(np.float32) * scale[:, None, None]
    ppq = (deq ** 2).sum(-1).astype(np.float32)
    d = t.shape[-1]
    eps = (0.5 * scale * np.sqrt(float(d))).astype(np.float32)
    return _planes(codes, scale, ppq, eps)


def quantize_tiles_bf16(tiles, valid) -> TilePlanes:
    """(T, cap, d) fp32 tiles -> bf16 planes. ``scale`` is kept (all
    ones) so the scan operands have one uniform shape per precision."""
    t = np.asarray(tiles, np.float32)
    v = np.asarray(valid, bool)
    tz = np.where(v[:, :, None], t, 0.0)
    data = torch.from_numpy(np.ascontiguousarray(tz, np.float32)).to(
        torch.bfloat16)
    deq = data.float().numpy()
    ppq = (deq ** 2).sum(-1).astype(np.float32)
    rown = np.sqrt((tz ** 2).sum(-1))
    eps = (BF16_EPS * rown.max(axis=1)).astype(np.float32) if t.size \
        else np.zeros(t.shape[0], np.float32)
    return _planes(data, np.ones(t.shape[0], np.float32), ppq, eps)


def plan_tiles(tiles, valid, precision: str) -> TilePlanes:
    """The one entry point the engine uses when it builds a layout."""
    if precision == "int8":
        return quantize_tiles_i8(tiles, valid)
    if precision == "bf16":
        return quantize_tiles_bf16(tiles, valid)
    raise ValueError(f"no tile planes for precision={precision!r}")


def quantize_query(qs: torch.Tensor, precision: str):
    """Per-query scan operands, shared by the plain version and the CUDA
    wrapper so both compute the identical widened bound.

    Returns (qcast, qscale (G,), qqq (G,), qeps (G,)): the reduced-
    precision query, its scale (ones for bf16), the exact squared norm
    of the DEQUANTIZED query, and the query-side L2 error bound."""
    qf = qs.float()
    d = qf.shape[-1]
    if precision == "int8":
        sq = torch.clamp_min(qf.abs().amax(dim=-1) / 127.0,
                             TILE_SCALE_FLOOR)
        qc = torch.clamp(torch.round(qf / sq[:, None]), -127.0, 127.0)
        qqq = (sq * sq) * torch.sum(qc * qc, dim=-1)
        qeps = 0.5 * sq * np.float32(math.sqrt(float(d)))
        return qc.to(torch.int8), sq, qqq, qeps
    if precision == "bf16":
        qb = qf.to(torch.bfloat16)
        qb32 = qb.float()
        qqq = torch.sum(qb32 * qb32, dim=-1)
        qeps = BF16_EPS * sqrt_rn(torch.sum(qf * qf, dim=-1))
        return qb, torch.ones(qf.shape[:-1], dtype=torch.float32,
                              device=qf.device), qqq, qeps
    raise ValueError(f"no query quantization for precision={precision!r}")
