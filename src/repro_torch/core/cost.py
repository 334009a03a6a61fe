"""Analytic cost features of the engine's stages (port of the feature
functions of ``repro/core/cost.py``).

The engine records every executed KNN and V.R stage as (kind, features,
observed seconds) into the QBS cost rings, and the planner's explain()
reads them back. The fitted ``CostModel`` and its calibration come with a
later slice; until then no model is attached and every path choice uses
the fixed thresholds, exactly as an uncalibrated reference platform does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.core.lake import _next_pow2


_SCAN_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def prec_scale(precision: str) -> float:
    """Relative cost of the scan precision against fp32: fp32 -> 1.0,
    bf16 -> 0.5, int8 -> 0.25. The card's scan kernels are bound by the
    bytes of the candidate rows they read, so the scale is the element
    width's (the reference takes the same ratios from its peak rates)."""
    if precision not in _SCAN_BYTES:
        raise ValueError(f"unknown scan precision {precision!r}")
    return _SCAN_BYTES[precision] / _SCAN_BYTES["fp32"]


def knn_kind(device_loop: bool) -> str:
    """Stage-kind key for one KNN group execution."""
    return "knn:device" if device_loop else "knn:host"


def loop_widths(device_loop: bool, beam: int, tiles: int,
                seed: Optional[int] = None) -> Tuple[int, int]:
    """(first-round width, straggler/doubling width) in tiles of the
    loop's scan layout — mirrors ``HybridEngine._run_jobs``."""
    tiles = max(1, int(tiles))
    beam = max(1, int(beam))
    if device_loop:
        w1 = max(1, min(max(1, beam // 2), tiles))
        ws = max(beam, _next_pow2(seed)) if seed else beam
        return w1, ws
    beam_eff = max(beam, _next_pow2(beam + seed)) if seed else beam
    w = max(1, min(beam_eff, tiles))
    return w, w


def knn_features(g: int, w1: int, ws: int, cap: int, dim: int, k: int,
                 tiles: int, precision: str) -> Tuple[float, ...]:
    """[bias, queries, first-round scan MFLOP-equivalents, candidate rows
    staged (1e6), top-k merge work (1e3), straggler round budget,
    collective volume (0 on one device)]."""
    g = max(1, int(g))
    w1 = max(1, int(w1))
    ws = max(1, int(ws))
    cap = max(1, int(cap))
    dim = max(1, int(dim))
    tiles = max(1, int(tiles))
    ps = prec_scale(precision)
    scan = g * w1 * cap * dim * ps / 1e6
    gather = g * w1 * cap / 1e6
    topk = g * k * math.log2(max(2.0, float(w1 * cap))) / 1e3
    rounds = float(-(-(tiles - w1) // ws)) if tiles > w1 else 1.0
    return (1.0, float(g), scan, gather, topk, rounds, 0.0)


def knn_plan_features(*, device_loop: bool, g: int, k: int, beam: int,
                      tiles: int, cap: int, dim: int, precision: str,
                      seed: Optional[int] = None) -> Tuple[float, ...]:
    """``knn_features`` with the round widths from ``loop_widths``."""
    w1, ws = loop_widths(device_loop, beam, tiles, seed)
    return knn_features(g, w1, ws, cap, dim, k, tiles, precision)


def vr_features(kind: str, g: int, union_tiles: int, cap: int, dim: int,
                n: int) -> Tuple[float, ...]:
    """[bias, queries, GEMM MFLOPs, rows staged (1e6), mask decode (1e6)]
    for one V.R group; the dense pass touches every row, the tile pass
    the pow2-padded union."""
    g = max(1, int(g))
    cap = max(1, int(cap))
    dim = max(1, int(dim))
    if kind == "vr:dense":
        rows = float(max(1, n))
    else:
        rows = float(_next_pow2(max(1, union_tiles)) * cap)
    return (1.0, float(g), g * rows * dim / 1e6, rows * dim / 1e6,
            g * rows / 1e6)
