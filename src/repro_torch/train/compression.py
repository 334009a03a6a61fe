"""Gradient compression: int8 codes with error feedback (the numeric
parts of ``repro/train/compression.py``).

Across pods, the data-parallel all-reduce of the reference's compressed
step sums per-channel int8 gradient codes and keeps the quantization
residual in an error-feedback buffer (Seide et al. 2014), so the bias of
the compression vanishes over steps. This module holds the arithmetic:
``quantize_grad`` / ``dequantize_grad``, ``compress_residual`` and
``init_error_tree``. The step that exchanges the codes over a pod axis
(``make_compressed_train_step``) comes with the dry run (ROADMAP queue 1
item 9, second half).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.utils.quant import div


def quantize_grad(g: torch.Tensor, axis: int = -1):
    scale = div(torch.amax(torch.abs(g), dim=axis, keepdim=True), 127.0)
    scale = torch.clamp_min(scale, 1e-20)
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_grad(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.float() * scale


def compress_residual(g: torch.Tensor, err: torch.Tensor):
    """Apply error feedback: quantize (g + err), return codes, scales and
    the new residual."""
    target = g + err
    codes, scale = quantize_grad(target)
    approx = dequantize_grad(codes, scale)
    return codes, scale, target - approx


def init_error_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """fp32 zeros of each parameter's shape, in the parameters' layout
    (a flat or nested dict)."""
    return {k: init_error_tree(p) if isinstance(p, dict)
            else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
