"""Peak rates of one NVIDIA H100 SXM (port of the peak table of
``repro/utils/roofline.py``).

NVIDIA's data sheet, dense rates without sparsity, at the card's full
700 W limit: float32 outside the tensor cores, the bf16 and int8
tensor-core rates, HBM3 bandwidth and NVLink 4. The kernels' roofline
bounds (``chip_smoke.py``), the cost model's precision scale and the dry
run's ``Roofline`` (``launch/dryrun.py``) read this one table, and
``model_flops_for`` (the reference's analytic 6 N D) gives MFU its
numerator.

``Roofline`` is the reference's, on this table:

  compute term    = FLOPs per device / peak FLOP/s of the program's type
  memory term     = HBM bytes per device / HBM_BW
  collective term = collective bytes per device / LINK_BW

The dry run counts FLOPs and bytes with ``utils/opcount.py`` instead of
XLA's HLO; the ``raw_*`` fields (XLA's ``cost_analysis``, loop bodies
counted once) hold the count before the trip weights. Where no SPMD
program exists (one card) ``collective_bytes_per_dev`` is None: the
collective term is 0 and the bottleneck is taken over compute and
memory.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # bytes/s of HBM3
PEAK_BYTES = HBM_BW           # the kernels' bounds read it by this name
# NVLink 4: 900 GB/s per card, both directions together (NVIDIA H100
# Tensor Core GPU data sheet, SXM5 form factor)
LINK_BW = 900e9

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


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # the count before trip weights (per device)
    raw_flops_per_dev: float
    raw_bytes_per_dev: float
    # the trip-weighted count (per device)
    flops_per_dev: float
    bytes_per_dev: float
    # None where no SPMD program exists (``collective_reason`` says why)
    collective_bytes_per_dev: Optional[float]
    collective_breakdown: Dict[str, float]
    # terms in seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0           # 6*N*D (global, analytic)
    useful_ratio: float = 0.0          # model_flops / global counted flops
    memory_per_dev_bytes: float = 0.0  # the dry run's peak per device
    roofline_fraction: float = 0.0     # t_compute / max(all terms)
    # the program's dominant compute type: finalize() divides FLOPs by
    # this type's peak
    dtype: str = "bf16"
    # how per-device work was taken from the traced program ("even": the
    # global count over n_devices) and why there is no collective term
    split: str = "even"
    collective_reason: str = ""

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops_per_dev / peak_flops(self.dtype)
        self.t_memory = self.bytes_per_dev / HBM_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.collective_bytes_per_dev is None:
            self.t_collective = 0.0
        else:
            self.t_collective = self.collective_bytes_per_dev / LINK_BW
            terms["collective"] = self.t_collective
        self.bottleneck = max(terms, key=terms.get)
        global_flops = self.flops_per_dev * self.n_devices
        self.useful_ratio = (self.model_flops / global_flops
                             if global_flops else 0.0)
        bound = max(terms.values())
        self.roofline_fraction = (self.t_compute / bound) if bound else 0.0
        return self

    def to_dict(self):
        return asdict(self)


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
