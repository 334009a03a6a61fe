"""Tiny cells for the CPU tests: the two traffic kinds on tables of a
few thousand rows and an embedder of small width, written as files into
a directory that the harness searches before its own."""
from __future__ import annotations

import copy
import json
import os

BLOBS = {
    "name": "tiny-blobs", "source": "test", "rows": 2000, "dim": 32,
    "reduced": [], "table": {"recipe": "gaussian_blobs", "column": "v",
                             "centers": 6, "center_scale": 6.0,
                             "numeric": {"price": [0.0, 100.0]}},
    "index": {"min_leaf": 32, "max_leaf": 256}, "precision": "fp32"}

TEXT = {
    "name": "tiny-text", "source": "test", "rows": 2000, "dim": 64,
    "reduced": [], "table": {"recipe": "topic_sphere", "column": "v",
                             "id_column": "id", "topics": 8,
                             "prompt_len": 32, "spread": 1.0},
    "embedder": {"name": "mqrld-embedder-100m", "num_layers": 2,
                 "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
                 "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0,
                 "dtype": "bfloat16"},
    "index": {"min_leaf": 32, "max_leaf": 256}, "precision": "int8"}

HYBRID = {
    "config": "tiny-blobs", "traffic": "hybrid", "kind": "batch_closed",
    "why": "test",
    "params": {"batch": 64, "archetypes": [
        [["vk", 20]], [["nr", "price", 25, 75], ["vk", 20]],
        [["vr"], ["nr", "price", 20, 80]], [["vr"], ["vk", 20]]],
        "warm_batches": 1, "radius_sample": 16, "radius_rank": 100,
        "sample": 48},
    "limits": {"mismatched_queries": 0}}

SERVE = {
    "config": "tiny-text", "traffic": "serve", "kind": "serve_open",
    "why": "test",
    "params": {"rate": 60, "lengths": [8, 16, 32], "redraw": 0.25,
               "archetypes": [[["vk", 10]],
                              [["nr", "id", 20, 2000], ["vk", 10]]],
               "batch_size": 8, "pipeline_depth": 2, "warm_seconds": 0.5,
               "sample": 32, "trace_seconds": 0.5},
    "limits": {"mismatched_requests": 0, "query_vector_gap": 0.05}}


HYBRID_CELL, SERVE_CELL = "tiny-blobs.hybrid", "tiny-text.serve"


def _metric(name, unit, better, source, cells, layer=None, moves=None,
            bound=None):
    m = {"name": name, "unit": unit, "better": better, "source": source}
    if layer is None:
        m["bound"] = bound
    else:
        m.update(layer=layer, moves=moves)
    if cells is not None:
        m["workloads"] = list(cells)
    return m


# written in full, so a cell added to the repository's BENCHMARK.json
# changes nothing here
END_TO_END = [
    _metric("qps", "queries/s", "higher", "host_clock", [HYBRID_CELL],
            bound=0.25),
    _metric("p95_ms", "ms", "lower", "host_clock", [SERVE_CELL], bound=0.25),
    _metric("setup_s", "s", "lower", "host_clock", None, bound=0.25)]

PER_LAYER = [
    _metric("planner.plan_ms", "ms", "lower", "host_clock", [HYBRID_CELL],
            "planner", "qps"),
    _metric("engine.rows_per_query", "rows", "lower", "program_counter",
            [HYBRID_CELL], "engine", "qps"),
    _metric("engine.rounds", "rounds", "lower", "program_counter",
            [HYBRID_CELL], "engine", "qps"),
    _metric("topk_l2_masked_roofline", "%", "higher", "device_trace",
            [HYBRID_CELL], "kernels", "qps"),
    _metric("pairwise_sq_l2_roofline", "%", "higher", "device_trace",
            [HYBRID_CELL], "kernels", "qps"),
    _metric("mp.rescued_per_query", "rows", "lower", "program_counter",
            [SERVE_CELL], "mixed-precision scan", "p95_ms"),
    _metric("quant_lb2_roofline", "%", "higher", "device_trace",
            [SERVE_CELL], "kernels", "p95_ms"),
    _metric("serve.chunk_fill", "requests", "higher", "program_counter",
            [SERVE_CELL], "retrieval server", "p95_ms"),
    _metric("serve.embed_share", "%", "lower", "host_clock", [SERVE_CELL],
            "embedder", "p95_ms"),
    _metric("serve.mfu", "%", "higher", "host_clock", [SERVE_CELL],
            "embedder", "p95_ms")]


def write(root: str, extra_cells=(), per_layer=()) -> str:
    """Write the tiny cells (and ``extra_cells``: (name, config, traffic))
    under ``root``; returns the path of its BENCHMARK.json."""
    for sub, name, obj in (("configs", "tiny-blobs", BLOBS),
                           ("configs", "tiny-text", TEXT),
                           ("workloads", HYBRID_CELL, HYBRID),
                           ("workloads", SERVE_CELL, SERVE)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    cells = [(HYBRID_CELL, "tiny-blobs", "hybrid"),
             (SERVE_CELL, "tiny-text", "serve"), *extra_cells]
    bench = {"command": ["python3", "perfbench/run.py"],
             "paths": ["perfbench"], "run_seconds": 1,
             "configs": [{"name": c, "source": "test",
                          "file": f"perfbench/configs/{c}.json",
                          "reduced": [], "why": "test"}
                         for c in sorted({c for _, c, _ in cells})],
             "workloads": [{"name": n, "config": c, "traffic": t,
                            "chips": 1, "why": "test"}
                           for n, c, t in cells],
             "end_to_end": copy.deepcopy(END_TO_END),
             "per_layer": copy.deepcopy(PER_LAYER) + list(per_layer)}
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path
