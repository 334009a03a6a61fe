"""A new configuration, cell, traffic kind, per-layer metric, kernel
roofline law and probe are new files (and entries in BENCHMARK.json)
only: written into a directory the harness searches, they run with no
edit to any file already there."""
import json
import os

from perfbench import harness, spec
from perfbench.tests import tiny

KIND = '''"""A traffic kind added as a file: the batch loop of V.K queries."""
from perfbench import spec

_base = spec.load_module("traffic", "batch_closed", [spec.PKG])
setup, window, evidence, check = (_base.setup, _base.window,
                                  _base.evidence, _base.check)
'''

METRIC = '''"""Queries per batch, a metric added as a file."""


def read(run):
    b = run.counters.get("batches")
    return run.counters["queries"] / b if b else None
'''


LAW = '''"""A kernel law added as a file: every call of the masked top-k
recorded, on any device."""
ENTRY = "topk_l2_masked"
SYMBOL = "no_such_kernel"
COUNTER = ("fused_topk", "topk_l2_masked_launches")


def shape(a, out):
    return a["p"].shape[0], a["k"]


def bound(g, k):
    return 1e-9 * g * k, "bytes"
'''

PROBE = '''"""A probe added as a file: calls of the masked top-k."""
ENTRY = "topk_l2_masked"


def counts(a, out):
    return {"topk_calls": 1}
'''

RECORDED = '''"""Calls the added kernel law recorded over the traced window."""


def read(run):
    k = (run.trace or {}).get("kernels", {}).get("topk_seen")
    return k["calls"] if k else None
'''

COUNTED = '''"""Calls the added probe counted."""


def read(run):
    return run.counters.get("topk_calls")
'''


def _metric(name, cells):
    return {"name": name, "unit": "calls", "better": "lower",
            "source": "program_counter", "layer": "engine", "moves": "qps",
            "workloads": cells}


def test_new_files_only(tmp_path):
    root = str(tmp_path)
    config = dict(tiny.BLOBS, name="tiny-wide", dim=48)
    cell = dict(tiny.HYBRID, config="tiny-wide", traffic="vk",
                kind="vk_batches")
    cell["params"] = dict(cell["params"], archetypes=[[["vk", 5]]])
    for sub, name, text in (
            ("configs", "tiny-wide.json", json.dumps(config)),
            ("workloads", "tiny-wide.vk.json", json.dumps(cell)),
            ("traffic", "vk_batches.py", KIND),
            ("metrics", "batch.queries.py", METRIC),
            ("laws/kernels", "topk_seen.py", LAW),
            ("probes", "topk_seen.py", PROBE),
            ("metrics", "topk.recorded.py", RECORDED),
            ("metrics", "topk.counted.py", COUNTED)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name), "w") as f:
            f.write(text)
    path = tiny.write(root, extra_cells=[("tiny-wide.vk", "tiny-wide", "vk")],
                      per_layer=[{"name": "batch.queries", "unit": "queries",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "engine", "moves": "qps",
                                  "workloads": ["tiny-wide.vk"]},
                                 _metric("topk.recorded", ["tiny-wide.vk"]),
                                 _metric("topk.counted", ["tiny-wide.vk"])])
    with open(path) as f:
        bench = json.load(f)
    for m in bench["end_to_end"]:            # entries, not edits
        if m["name"] == "qps":
            m["workloads"].append("tiny-wide.vk")
    with open(path, "w") as f:
        json.dump(bench, f)
    dirs = [root, spec.PKG]
    out, code = harness.run("tiny-wide.vk", 3, 1.0, True, device="cpu",
                            benchmark=path, dirs=dirs)
    assert code == 0 and out["correct"] is True
    assert out["metrics"]["batch.queries"]["value"] == 64
    # the whole window traced: the law saw every call the probe counted
    calls = out["metrics"]["topk.counted"]["value"]
    assert calls > 0 and out["metrics"]["topk.recorded"]["value"] == calls
    out, code = harness.run("tiny-wide.vk", 3, 1.0, False, device="cpu",
                            benchmark=path, dirs=dirs)
    assert set(out["metrics"]) == {"qps", "setup_s"}


def test_a_cell_added_to_the_repository_leaves_the_tiny_cells(tmp_path):
    """The repository's BENCHMARK.json with one more cell, listed by its
    metrics: every cell of it still loads, and the tiny cells do too."""
    root = str(tmp_path)
    with open(spec.BENCHMARK) as f:
        bench = json.load(f)
    new = "tiny-wide.vk"
    bench["configs"].append({"name": "tiny-wide", "source": "test",
                             "file": "perfbench/configs/tiny-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": new, "config": "tiny-wide",
                               "traffic": "vk", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(new)
    for sub, name, obj in (
            ("configs", "tiny-wide", dict(tiny.BLOBS, name="tiny-wide")),
            ("workloads", new, dict(tiny.HYBRID, config="tiny-wide",
                                    traffic="vk"))):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    real = os.path.join(root, "real.json")
    with open(real, "w") as f:
        json.dump(bench, f)
    dirs = [root, spec.PKG]
    for w in bench["workloads"]:
        cell = spec.load(w["name"], benchmark=real, dirs=dirs)
        for m in cell.per_layer:
            spec.load_module("metrics", m["name"], dirs)
    path = tiny.write(root)
    for name in (tiny.HYBRID_CELL, tiny.SERVE_CELL):
        assert spec.load(name, benchmark=path, dirs=dirs).per_layer


def test_a_metric_without_cells_follows_what_it_moves(tmp_path):
    """A per-layer metric with no ``workloads`` is reported in every cell
    that reports the end-to-end metric it moves, and in no other."""
    m = {"name": "serve.chunk_fill", "unit": "requests", "better": "higher",
         "source": "program_counter", "layer": "retrieval server",
         "moves": "p95_ms"}
    path = tiny.write(str(tmp_path), per_layer=[dict(m, name="x.fill")])
    dirs = [str(tmp_path), spec.PKG]
    names = {c: [x["name"] for x in spec.load(
        c, benchmark=path, dirs=dirs).per_layer]
        for c in (tiny.HYBRID_CELL, tiny.SERVE_CELL)}
    assert "x.fill" in names[tiny.SERVE_CELL]
    assert "x.fill" not in names[tiny.HYBRID_CELL]
