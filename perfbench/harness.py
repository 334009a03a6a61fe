"""One run of one cell: set up from the seed, measure for ``seconds``,
judge what the timed path produced against the plain reference, and
print the result line.

A traffic kind (``traffic/<kind>.py``) provides ``setup(ctx)`` (build
the inputs and the system, warm the cell's shapes), ``window(ctx,
world)`` (drive the system while the window is open, setting the
end-to-end values in ``ctx.e2e``), ``evidence(ctx, world)`` (what the
reference judges, copied out of the program) and ``check(ctx,
evidence)`` (the compared numbers). Each per-layer metric is
``metrics/<name>.py`` with ``read(run)``, which returns None when there
is nothing to read; the metric is then left out of the line."""
from __future__ import annotations

import gc
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench import inputs, spec
from perfbench.record import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Ctx:
    """What a traffic kind sees of its run."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 device, rec: Recorder):
        self.cell = cell
        self.config = cell.config
        self.params = cell.workload["params"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.rec = rec
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stage(self, name: str, t0: float) -> float:
        """Log a set-up stage's seconds on standard error; returns now."""
        t = time.perf_counter()
        print(f"setup: {name} {t - t0:.3f} s", file=sys.stderr, flush=True)
        return t

    def table(self, world: dict) -> dict:
        recipe = spec.load_module("tables", self.config["table"]["recipe"],
                                  self.cell.dirs)
        t0 = time.perf_counter()
        out = recipe.make(self.config, self.seed, self.device, world)
        self.sync()
        self.stage("table", t0)
        return out

    def platform(self, table: dict):
        """``MQRLD(table).prepare(**index)`` on the device."""
        from repro_torch.core.lake import MMOTable
        from repro_torch.core.platform import MQRLD
        t = MMOTable(self.config["name"])
        # copies: the reference reads the benchmark's own arrays
        for col, v in table["vector"].items():
            t = t.add_vector(col, v.copy())
        for col, v in table["numeric"].items():
            t = t.add_numeric(col, v.copy())
        p = MQRLD(t, seed=inputs.seed_state(self.seed, 3) % 2 ** 32,
                  device=None if self.device.type == "cuda" else self.device)
        t0 = time.perf_counter()
        p.prepare(**self.config["index"])
        self.sync()
        self.stage("prepare", t0)
        return p


class Run:
    """What the per-layer readers read: the host clock's spans and the
    counters over the window, or, where only its tail was traced, over
    the part before the profiler started; the trace's reduction over the
    traced part."""

    def __init__(self, ctx: Ctx, trace: Optional[dict]):
        self.window_s, self.counters, self.spans = ctx.rec.part()
        self.trace = trace


def physical_to_logical(row_ids: Optional[np.ndarray], view_vec: np.ndarray,
                        view_num: Dict[str, np.ndarray], raw_vec: np.ndarray,
                        raw_num: Dict[str, np.ndarray], rows: np.ndarray
                        ) -> Tuple[np.ndarray, bool]:
    """The program's answer rows (ids into its re-laid table) as logical
    ids, and whether each such row holds exactly the raw row it claims."""
    rows = np.asarray(rows, np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= len(view_vec)):
        return rows, False
    logical = rows if row_ids is None else np.asarray(row_ids)[rows]
    if len(rows) and (logical.min() < 0 or logical.max() >= len(raw_vec)):
        return logical, False
    same = np.array_equal(view_vec[rows], raw_vec[logical]) and all(
        np.array_equal(view_num[c][rows], raw_num[c][logical])
        for c in raw_num)
    return logical, same


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name
    (the port's name begins with the JAX package's)."""
    return sorted(m for m in (sys.modules if modules is None else modules)
                  if m.split(".")[0] in FORBIDDEN)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", benchmark: str = spec.BENCHMARK,
        dirs: Sequence[str] = (spec.PKG,)) -> Tuple[dict, int]:
    """One run; returns (the result line's object, exit code). The
    command refuses the result if JAX was loaded (``main``)."""
    cell = spec.load(name, benchmark=benchmark, dirs=dirs)
    kind = spec.load_module("traffic", cell.workload["kind"], cell.dirs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = Recorder(trace)
    tracer = None
    if trace:
        from perfbench.trace import Trace
        tracer = Trace(rec, device, seconds,
                       cell.workload["params"].get("trace_seconds"),
                       dirs=cell.dirs)
    ctx = Ctx(cell, seed, seconds, device, rec)
    t0 = time.perf_counter()
    world = kind.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    kind.window(ctx, world)
    ctx.sync()
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    reduced = tracer.reduce() if tracer else None
    evidence = kind.evidence(ctx, world)
    del world
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check(ctx, evidence)
    limits = cell.workload["limits"]
    compared = {}
    for key, value in checks.items():
        if key not in limits:
            raise KeyError(f"{name}: no limit for {key}")
        compared[key] = {"value": value, "limit": limits[key]}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not trace:
        values = dict(ctx.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        view = Run(ctx, reduced)
        for m in cell.per_layer:
            reader = spec.load_module("metrics", m["name"], cell.dirs)
            v = reader.read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device)
           if ctx.device.type == "cuda" else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["compared"] = compared
    for key, c in compared.items():
        print(f"compared {key} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return out, 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load(a.workload)
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    chips = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    out, code = run(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    emit(out)
    return code


def emit(out: dict) -> None:
    """The result as the last line of standard output."""
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


