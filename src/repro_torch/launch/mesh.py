"""Production mesh construction (port of ``repro/launch/mesh.py``).

A mesh here is logical: axis names and sizes, no devices. The reference
builds a JAX mesh over placeholder devices so XLA can partition a cell's
program; the port has no SPMD partitioner, and the dry run reads only
the names and sizes (``rules_for_mesh``, and the spec division of
``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        """The number of devices the mesh stands for."""
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_dev_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A small mesh: (data, model), or (pod, data, model) when ``pod``."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))
