"""Peak rates of one NVIDIA H100 SXM (port of the peak table of
``repro/utils/roofline.py``).

NVIDIA's data sheet, dense rates without sparsity, at the card's full
700 W limit: float32 outside the tensor cores, the bf16 and int8
tensor-core rates, and HBM3 bandwidth. The kernels' roofline bounds
(``chip_smoke.py``) and the cost model's precision scale read this one
table, and ``model_flops_for`` (the reference's analytic 6 N D) gives the
training path's MFU its numerator. The reference's HLO ``Roofline``
belongs to the dry run (``launch/dryrun.py``) and comes with it (ROADMAP
queue 1 item 9, second half).
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989e12      # FLOP/s
PEAK_BYTES = 3.35e12          # bytes/s of HBM3

PEAK_FLOPS: Dict[str, float] = {
    "fp32": 67e12,
    "bf16": PEAK_FLOPS_BF16,
    "int8": 1979e12,
}


def peak_flops(dtype: str) -> float:
    """Peak operations per second for ``dtype`` ("fp32" | "bf16" |
    "int8"); an unknown dtype falls back to the bf16 peak, as the
    reference's does."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS_BF16)


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for train, 2*N*D for forward-only, per
    step; D = tokens processed. MoE counts active params only."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
