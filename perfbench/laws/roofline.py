"""The least time one NVIDIA H100 could take for a kernel's call: the
larger of its operations over the peak for their type and its bytes over
the memory rate, each input read once and each output written once.
Where the work depends on the data, only what these inputs need counts
(valid candidates; no candidate its lower bound rules out), so no
implementation can read above 100% of its bound. Each kernel's law is
``laws/kernels/<kernel>.py``.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit: fp32 outside the tensor cores 67 TFLOP/s, TF32 495, bf16 989,
int8 1,979 TOP/s; HBM3 3.35 TB/s."""
from __future__ import annotations

from typing import Tuple

PEAK_OPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
            "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, kind: str = "fp32"
            ) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time and what sets it."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
