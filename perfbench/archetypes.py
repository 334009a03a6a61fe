"""Query archetypes as the traffic files write them, turned into the
program's MOAPI trees and into the reference's form
(``reference/bruteforce.py``) from the same numbers. An archetype is a
list of parts about one query vector: ``["vk", k]``, ``["nr", attr, lo,
hi]`` and ``["vr"]`` (the cell's radius). One part is that query alone;
several are their intersection, in the order written."""
from __future__ import annotations

from typing import Optional

import numpy as np


def program_query(Q, arch: list, attr: str, vec: np.ndarray,
                  radius: Optional[float] = None):
    parts = []
    for p in arch:
        if p[0] == "vk":
            parts.append(Q.VK.of(attr, vec, int(p[1])))
        elif p[0] == "nr":
            parts.append(Q.NR(p[1], float(p[2]), float(p[3])))
        elif p[0] == "vr":
            parts.append(Q.VR.of(attr, vec, float(radius)))
        else:
            raise ValueError(f"unknown archetype part {p!r}")
    return parts[0] if len(parts) == 1 else Q.And.of(*parts)


def reference_query(arch: list, vec: np.ndarray,
                    radius: Optional[float] = None) -> dict:
    q = {"vec": np.asarray(vec, np.float32), "nr": [], "vr": None,
         "vk": None}
    for p in arch:
        if p[0] == "vk":
            q["vk"] = int(p[1])
        elif p[0] == "nr":
            q["nr"].append((p[1], float(p[2]), float(p[3])))
        elif p[0] == "vr":
            q["vr"] = float(radius)
    return q


def top_level_vk(arch: list) -> bool:
    """A lone V.K answers in distance order; an intersection is a set."""
    return len(arch) == 1 and arch[0][0] == "vk"
