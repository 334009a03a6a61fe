"""Finding a cell's files by name. ``BENCHMARK.json`` lists the cells and
metrics; each cell is ``workloads/<cell>.json``, each configuration
``configs/<config>.json``, each traffic kind ``traffic/<kind>.py``, each
table recipe ``tables/<recipe>.py``, each per-layer metric
``metrics/<metric>.py``, and in traced runs each kernel's roofline law
``laws/kernels/<kernel>.py`` and each counter read from a kernel entry
point ``probes/<name>.py``. Files are looked up in a list of directories,
first hit wins, so a new cell, configuration, kind or metric is a new
file and nothing else."""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def find(subdir: str, name: str, ext: str, dirs: Sequence[str]) -> str:
    for d in dirs:
        path = os.path.join(d, subdir, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {subdir}/{name}{ext} under {list(dirs)}")


def load_json(subdir: str, name: str, dirs: Sequence[str]) -> dict:
    with open(find(subdir, name, ".json", dirs)) as f:
        return json.load(f)


_modules: Dict[str, object] = {}


def load_module(subdir: str, name: str, dirs: Sequence[str]):
    """The module in ``<dir>/<subdir>/<name>.py`` (a name may hold dots)."""
    path = find(subdir, name, ".py", dirs)
    if path not in _modules:
        mod_name = re.sub(r"\W", "_", f"perfbench_{subdir}_{name}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def found(subdir: str, dirs: Sequence[str]) -> Dict[str, object]:
    """Every module ``<dir>/<subdir>/<name>.py`` by name, first directory
    first."""
    names = sorted({os.path.basename(f)[:-3] for d in dirs
                    for f in glob.glob(os.path.join(d, subdir, "*.py"))}
                   - {"__init__"})
    return {n: load_module(subdir, n, dirs) for n in names}


def applies(metric: dict, cell: str, reported: Sequence[str] = ()) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells it lists, or
    without a list every cell (a per-layer metric: every cell that
    reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    dirs: List[str]


def load(name: str, *, benchmark: str = BENCHMARK,
         dirs: Sequence[str] = (PKG,)) -> Cell:
    with open(benchmark) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name!r} is not a workload of {benchmark}")
    dirs = list(dirs)
    workload = load_json("workloads", name, dirs)
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    config = load_json("configs", entry["config"], dirs)
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name, entry, workload, config, e2e, layer, dirs)
