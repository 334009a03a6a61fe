"""The port's developer scripts (``repro_torch.scripts``) on the CPU:
``smoke_models`` over every config, ``flash_projection``'s score-class
rule and projection, and ``render_experiments``' tables against the
reference script's own functions.

The reference's ``scripts/flash_projection.py`` cannot be imported here
(it forces 512 host devices through ``repro.launch.dryrun``), so its
``score_class`` function is compiled alone from that file's source.
``scripts/render_experiments.py`` imports only the standard library and
is loaded by path.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_configs
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import ShapeConfig, all_configs, get_config
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.scripts import flash_projection as fp
from repro_torch.scripts import render_experiments as rx
from repro_torch.scripts import smoke_models

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _ref_script(name):
    return os.path.join(ROOT, "scripts", name)


# ---------------------------------------------------------------------------
# smoke_models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    return smoke_models.main(["--device", "cpu"])


def test_smoke_models_covers_the_reference_configs(smoke):
    assert smoke["ok"]
    assert sorted(smoke["configs"]) == sorted(all_configs()) == \
        sorted(ref_configs())


@pytest.mark.parametrize("name", sorted(all_configs()))
def test_smoke_models_finite(smoke, name):
    r = smoke["configs"][name]
    assert r["ok"], r.get("error")
    assert np.isfinite(r["loss"]) and np.isfinite(r["gnorm"])
    assert r["gnorm"] > 0
    # the reduced config's vocabulary is 256: the loss at init is near
    # log(256); the parameter count is the reference model's
    assert abs(r["loss"] - np.log(256)) < 1.0
    assert r["n_params"] == ref_build(ref_config(name).reduced()).n_params()


def test_smoke_models_fails_loudly(monkeypatch):
    """A config that fails is reported and makes ``ok`` false (the
    script's exit code)."""
    def broken(cfg, dev):
        raise ValueError("broken")
    monkeypatch.setattr(smoke_models, "smoke", broken)
    out = smoke_models.main(["--device", "cpu"])
    assert not out["ok"]
    assert all(not r["ok"] and "broken" in r["error"]
               for r in out["configs"].values())


def test_smoke_models_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke_models.main([])


# ---------------------------------------------------------------------------
# flash_projection
# ---------------------------------------------------------------------------
def _ref_score_class():
    """The reference script's ``score_class``, compiled from its source."""
    src = open(_ref_script("flash_projection.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "score_class")
    ns = {"re": re}
    exec(compile(ast.Module([fn], []), "flash_projection.py", "exec"), ns)
    return ns["score_class"]


def _shapes():
    rng = np.random.default_rng(0)
    out = [(2, 8, 2048, 2048), (4096, 4096), (2048, 4096), (1, 2047, 2047),
           (2048,), (), (3, 2048, 16, 2048), (8192, 128, 8192),
           (2, 4096, 4096, 1)]
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        out.append(tuple(int(x) for x in rng.choice(
            [1, 2, 16, 128, 1024, 2047, 2048, 4096, 32768], nd)))
    return out


def test_score_class_is_the_reference_rule():
    ref = _ref_score_class()
    shapes = _shapes()
    hits = 0
    for s in shapes:
        hlo = f"f32[{','.join(map(str, s))}]{{3,2,1,0}}"
        assert fp.score_class(hlo) == ref(hlo) == fp.score_shape(s), s
        hits += ref(hlo)
    # tuples of shapes, as HLO writes a multi-output op's type
    for a, b in zip(shapes, shapes[1:]):
        t = (f"(bf16[{','.join(map(str, a))}], "
             f"s32[{','.join(map(str, b))}])")
        assert fp.score_class(t) == ref(t)
    assert 0 < hits < len(shapes)


@pytest.fixture(scope="module")
def small_cell():
    """olmo-1b's reduced config trained at seq 2048 on one device: its
    dense attention scores are (B, H, 2048, 2048)."""
    cfg = get_config("olmo-1b").reduced()
    return fp.project("olmo-1b", ShapeConfig("t2k", 2048, 2, "train"),
                      cfg=cfg, mesh=make_dev_mesh(1, 1))


def test_flash_projection_small_cell(small_cell):
    r = small_cell
    assert 0 < r["score_bytes_per_dev"] < r["bytes_per_dev"]
    assert r["t_memory_flash"] <= r["t_memory"]
    assert r["t_memory_flash"] == pytest.approx(
        (r["bytes_per_dev"] - r["score_bytes_per_dev"]) / fp.HBM_BW)
    assert r["roofline_fraction_flash"] >= r["roofline_fraction"]
    dr = r["dry_run"]
    assert dr["roofline"]["bytes_per_dev"] == r["bytes_per_dev"]
    assert dr["n_devices"] == 1


def test_flash_projection_counts_what_the_plain_counter_counts(small_cell):
    """The subclass only adds a tally: the dry run's count is the plain
    counter's."""
    from repro_torch.launch import dryrun as dr
    cfg = get_config("olmo-1b").reduced()
    plain = dr.dry_run(cfg, ShapeConfig("t2k", 2048, 2, "train"),
                       make_dev_mesh(1, 1), dr.overrides("olmo-1b", "train"),
                       arch="olmo-1b")
    got = small_cell["dry_run"]
    for k in ("flops_per_dev", "bytes_per_dev", "t_memory", "t_compute"):
        assert got["roofline"][k] == plain["roofline"][k]
    assert got["memory"] == plain["memory"]


def test_entry_points_run_as_modules():
    """Every example and script runs as ``python -m`` (here ``--help``)."""
    mods = [f"repro_torch.examples.{m}" for m in (
        "quickstart", "precision_scan", "query_aware_tuning",
        "serve_retrieval", "serve_pipelined", "serve_sharded",
        "train_embedder")] + [f"repro_torch.scripts.{m}" for m in (
            "smoke_models", "flash_projection", "render_experiments")]
    code = ("import runpy, sys\n"
            f"for m in {mods!r}:\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module(m, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n"
            "    print('ran', m)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("ran ") == len(mods)
    # each --help's usage line and option list: all but the CPU tools
    assert out.stdout.count("--device DEVICE") == 2 * 8


# ---------------------------------------------------------------------------
# render_experiments
# ---------------------------------------------------------------------------
def _ref_render():
    spec = importlib.util.spec_from_file_location(
        "ref_render_experiments", _ref_script("render_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cells(seed):
    """Dry-run rows with the same numbers in the port's keys and in the
    reference's."""
    rng = np.random.default_rng(seed)
    port, ref = {}, {}
    for arch in ("llama3-8b", "olmo-1b", "xlstm-1.3b"):
        for shape in ("train_4k", "decode_32k"):
            for mesh in ("16x16", "2x16x16"):
                tc, tm, tl = rng.uniform(0.001, 2, 3)
                rl = dict(t_compute=tc, t_memory=tm, t_collective=tl,
                          bottleneck=("compute", "memory", "collective")[
                              int(np.argmax([tc, tm, tl]))],
                          roofline_fraction=tc / max(tc, tm, tl),
                          useful_ratio=float(rng.uniform(0, 1)),
                          model_flops=float(rng.uniform(1e12, 1e16)),
                          flops_per_dev=float(rng.uniform(1e10, 1e14)))
                mem = {"peak_per_device_bytes": int(rng.integers(1, 2**36))}
                cc = {"all-reduce": int(rng.integers(0, 9)),
                      "all-gather": int(rng.integers(0, 9))}
                t = round(float(rng.uniform(0, 30)), 1)
                key = (arch, shape, mesh)
                base = dict(arch=arch, shape=shape, mesh=mesh, memory=mem,
                            roofline=rl)
                port[key] = dict(base, trace_s=t,
                                 ops={"collective_counts": cc})
                ref[key] = dict(base, compile_s=t,
                                hlo={"collective_counts": cc})
    return port, ref


def test_render_tables_equal_the_reference_scripts():
    ref = _ref_render()
    port_rows, ref_rows = _cells(0)
    opt_port, opt_ref = _cells(1)
    got = rx.dryrun_table(port_rows).splitlines()
    want = ref.dryrun_table(ref_rows).splitlines()
    assert got[0] == want[0].replace("compile s", "trace s")
    assert got[1:] == want[1:]
    assert len(got) == 2 + len(port_rows)
    for mesh in ("16x16", "2x16x16"):
        assert rx.roofline_table(port_rows, mesh) == \
            ref.roofline_table(ref_rows, mesh)
    assert rx.compare(port_rows, opt_port) == ref.compare(ref_rows, opt_ref)


def test_render_main_reads_dry_run_jsons(small_cell, tmp_path, capsys):
    """``main`` over a directory of the port's dry-run JSONs (one written
    by the projection's cell, one copy as the optimized run)."""
    for d in ("base", "opt"):
        os.makedirs(tmp_path / d)
        with open(tmp_path / d / "cell.json", "w") as f:
            json.dump(small_cell["dry_run"], f)
    tables = rx.main(["--dir", str(tmp_path / "base"),
                      "--opt-dir", str(tmp_path / "opt")])
    assert set(tables) == {"dryrun", "roofline", "compare"}
    row = tables["dryrun"].splitlines()[2]
    assert row.startswith("| olmo-1b | t2k | 1x1 |")
    assert f"| {small_cell['dry_run']['trace_s']} |" in row
    # one device: the roofline table (16 x 16) has no row for it
    assert len(tables["roofline"].splitlines()) == 2
    assert "1.0x better" in tables["compare"]
    assert "trace s" in capsys.readouterr().out
