"""A table of vectors around Gaussian centres with uniform numeric
columns: ``rows`` x ``dim`` fp32 rows, each a centre (N(0, 1) x
``center_scale``, one of ``centers``) plus N(0, 1) noise; each numeric
column uniform in its [lo, hi). Drawn on the device from the seed."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs


def make(config: dict, seed: int, device, world: dict) -> dict:
    t = config["table"]
    rows, dim = int(config["rows"]), int(config["dim"])
    gen = inputs.generator(seed, device, 10)
    centers = torch.randn((t["centers"], dim), generator=gen,
                          device=device) * float(t["center_scale"])
    cat = torch.randint(0, t["centers"], (rows,), generator=gen,
                        device=device)
    vec = centers[cat] + torch.randn((rows, dim), generator=gen,
                                     device=device)
    numeric = {}
    for name, (lo, hi) in t["numeric"].items():
        u = torch.rand((rows,), generator=gen, device=device)
        numeric[name] = (lo + (hi - lo) * u).cpu().numpy().astype(np.float32)
    return {"vector": {t["column"]: vec.cpu().numpy()}, "numeric": numeric}
