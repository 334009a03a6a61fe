"""Each traffic kind end to end on the CPU at a tiny size, untraced and
traced: the result line's keys, its metrics, its compared numbers; and
the command's refusal without a CUDA device."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from perfbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(out) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        harness.emit(out)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell,e2e,layer", [
    ("tiny-blobs.hybrid", {"qps", "setup_s"},
     {"planner.plan_ms", "engine.rows_per_query", "engine.rounds"}),
    ("tiny-text.serve", {"p95_ms", "setup_s"},
     {"serve.chunk_fill", "serve.embed_share", "serve.mfu",
      "mp.rescued_per_query"}),
])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(bench, cell, e2e, layer, trace):
    path, dirs = bench
    out, code = harness.run(cell, 2 ** 31 + 11, 1.0, trace, device="cpu",
                            benchmark=path, dirs=dirs)
    assert code == 0
    line = _line(out)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert set(line) <= set(KEYS) | {"breakdown", "compared"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == (layer if trace else e2e)
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["platform"] == "cpu"
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_refuses_without_a_card():
    root = os.path.dirname(harness.spec.PKG)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "laion-b32-200k.hybrid", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_command_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    root = os.path.dirname(harness.spec.PKG)
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.spec.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "laion-b32-200k.hybrid", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "program is not in this checkout" in p.stderr
