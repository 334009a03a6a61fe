"""The dry run against the JAX package: mesh rules, partition specs and
abstract trees leaf by leaf for every config on both production meshes,
the H100 ``Roofline``, the op counter's FLOPs against the reference's
HLO count, and ``launch/dryrun.py``'s cells.

The reference's mesh is a JAX mesh over placeholder devices; its rules
read only the axis names and the devices' shape, so a stand-in with
``devices = np.empty(shape)`` serves here (no 256 devices).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.sharding import partitioning as jpart
from repro.train import optimizer as jopt
from repro.utils import hlo
from repro_torch.configs import ShapeConfig, all_configs
from repro_torch.configs import get_config as tget
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.zoo import build_model as tbuild
from repro_torch.models.zoo import masters_from_numpy
from repro_torch.sharding.partitioning import MeshRules, P, rules_for_mesh
from repro_torch.train import optimizer as topt
from repro_torch.train.step import loss_and_grads
from repro_torch.utils import opcount, roofline

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
VARIANTS = [(f, fp, tp) for f in (True, False) for fp in (True, False)
            for tp in (True, False)]


def _ref_mesh(multi_pod):
    m = make_production_mesh(multi_pod=multi_pod)
    return types.SimpleNamespace(axis_names=m.axis_names,
                                 devices=np.empty(m.shape))


def _rules(multi_pod, fsdp=True, fsdp_over_pods=False, tp=True):
    return (jpart.rules_for_mesh(_ref_mesh(multi_pod), fsdp=fsdp,
                                 fsdp_over_pods=fsdp_over_pods,
                                 tensor_parallel=tp),
            rules_for_mesh(make_production_mesh(multi_pod=multi_pod),
                           fsdp=fsdp, fsdp_over_pods=fsdp_over_pods,
                           tensor_parallel=tp))


def _spec(x):
    return tuple(x)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp,fsdp_over_pods,tp", VARIANTS)
def test_rules_for_mesh_match(multi_pod, fsdp, fsdp_over_pods, tp):
    j, t = _rules(multi_pod, fsdp, fsdp_over_pods, tp)
    for f in ("dp", "tp", "fsdp", "sp", "sizes"):
        assert getattr(t, f) == getattr(j, f), f
    assert isinstance(t, MeshRules)


def test_substrate_rule_cases():
    """``tests/test_substrate.py``'s sharding-rule cases, on the port."""
    r = MeshRules(dp=("data",), tp="model", fsdp=("data",),
                  sizes=(("data", 16), ("model", 16)))
    assert r.spec_for((32, 64), ("batch", "ff")) == P("data", "model")
    assert r.spec_for((32, 14, 64), ("batch", "heads", None)) == \
        P("data", None, None)
    assert r.kv_spec((4, 1, 4096, 8, 64),
                     (None, "batch", None, "kv_heads", None),
                     batch_dim=1, seq_dim=2) == \
        P(None, None, ("data", "model"), None, None)
    assert r.kv_spec((4, 128, 4096, 8, 64),
                     (None, "batch", None, "kv_heads", None),
                     batch_dim=1, seq_dim=2) == \
        P(None, "data", "model", None, None)
    r = MeshRules(sizes=(("data", 16), ("model", 16)))
    assert r.flat_spec(256) == P(("data", "model"), None)
    assert r.flat_spec(16) == P("data", None)
    assert r.flat_spec(3) == P(None, None)
    with pytest.raises(KeyError):
        r.spec("nonsense")


LOGICAL = [None, "batch", "fsdp", "seq_sp", "vocab", "heads", "kv_heads",
           "ff", "experts", "model", "layers", "embed", "seq", "state"]
DIMS = [1, 2, 3, 4, 8, 14, 16, 25, 32, 48, 64, 96, 128, 256, 512, 4096]


@settings(max_examples=300, deadline=None)
@given(st.sampled_from([(m, *v) for m in (False, True) for v in VARIANTS]),
       st.lists(st.tuples(st.sampled_from(DIMS), st.sampled_from(LOGICAL)),
                min_size=2, max_size=6),
       st.data())
def test_specs_match_reference(rule_key, dims, data):
    """spec / spec_for / kv_spec / flat_spec of random logical patterns and
    shapes, under every rules variant of both production meshes."""
    j, t = _rules(*rule_key)
    shape = tuple(d for d, _ in dims)
    logical = tuple(a for _, a in dims)
    assert _spec(t.spec(*logical)) == _spec(j.spec(*logical))
    assert _spec(t.spec_for(shape, logical)) == \
        _spec(j.spec_for(shape, logical))
    b = data.draw(st.integers(0, len(shape) - 1))
    s = data.draw(st.integers(0, len(shape) - 1))
    assert _spec(t.kv_spec(shape, logical, b, s)) == \
        _spec(j.kv_spec(shape, logical, b, s))
    assert _spec(t.flat_spec(shape[0])) == _spec(j.flat_spec(shape[0]))


# ------------------------------------------------- trees of every config
def _dt(x) -> str:
    return str(x).replace("torch.", "")


def _same_abstract(t, j):
    assert tuple(t.shape) == tuple(j.shape)
    assert _dt(t.dtype) == str(np.dtype(j.dtype))


def _flat_ref(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat_ref(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _cache_fields(t):
    return [f.name for f in dataclasses.fields(t) if f.name != "graph"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_model_trees_match_reference(arch, multi_pod):
    """``abstract_params`` (shapes and types), ``param_specs``,
    ``input_shardings`` of every shape cell, ``cache_abstract`` (the
    cache or xlstm's state, at every serving cell) and ``adam_specs``
    (fp32 and int8) equal the reference's leaf by leaf, at full size,
    under the dry run's rules for the config."""
    over = dryrun.overrides(arch, "train")
    cfg_t, cfg_j = tget(arch), jget(arch)
    j_rules, t_rules = _rules(multi_pod, cfg_t.fsdp,
                              over["fsdp_over_pods"],
                              over["tensor_parallel"])
    jm, tm = jbuild(cfg_j, j_rules), tbuild(cfg_t, "cpu", rules=t_rules)
    j_abs, t_abs = _flat_ref(jm.abstract()), dryrun._flat(tm.abstract())
    j_spec, t_spec = _flat_ref(jm.specs()), dryrun._flat(tm.specs())
    assert list(j_abs) == list(t_abs) == list(t_spec)
    for path in t_abs:
        _same_abstract(t_abs[path], j_abs[path])
        assert _spec(t_spec[path]) == _spec(j_spec[path]), path
    for sd in ("float32", "bfloat16", "int8"):
        j_os = jopt.adam_specs(jm.abstract(), jm.specs(), j_rules, sd)
        t_os = topt.adam_specs(t_abs, t_spec, t_rules, sd)
        j_oa = jopt.adam_abstract(jm.abstract(), sd)
        t_oa = topt.adam_abstract(t_abs, sd)
        for field in ("m", "v"):
            jf = _flat_ref(getattr(j_os, field))
            ja = _flat_ref(getattr(j_oa, field))
            for path, ts in getattr(t_os, field).items():
                ta = getattr(t_oa, field)[path]
                if isinstance(ts, tuple) and not isinstance(ts, P):
                    assert [_spec(x) for x in ts] == \
                        [_spec(x) for x in jf[path]], path
                    for a, b in zip(ta, ja[path]):
                        _same_abstract(a, b)
                else:
                    assert _spec(ts) == _spec(jf[path]), path
                    _same_abstract(ta, ja[path])
        assert _spec(t_os.count) == _spec(j_os.count) == ()
    for shape in cfg_t.shape_cells():
        j_in = jm.input_shardings(shape)
        t_in = tm.input_shardings(shape)
        assert sorted(j_in) == sorted(t_in)
        for k in t_in:
            assert _spec(t_in[k]) == _spec(j_in[k]), (shape.name, k)
        if shape.kind == "train":
            continue
        (t_ca, t_cs), (j_ca, j_cs) = (
            tm.cache_abstract(shape.global_batch, shape.seq_len),
            jm.cache_abstract(shape.global_batch, shape.seq_len))
        for name in _cache_fields(t_ca):
            _same_abstract(getattr(t_ca, name), getattr(j_ca, name))
            assert _spec(getattr(t_cs, name)) == \
                _spec(getattr(j_cs, name)), (shape.name, name)


def test_reference_launcher_tables_and_cells_match():
    """``all_cells`` (32 a mesh, 64 for both) and the override tables equal
    the reference's. The reference's module forces 512 host devices when
    imported, so it is read in a process of its own."""
    code = ("import json\n"
            "from repro.launch import dryrun as d\n"
            "print(json.dumps({'cells': d.all_cells('both'), "
            "'train': d.TRAIN_OVERRIDES, 'default': d.DEFAULT_TRAIN, "
            "'opt': d.OPT_OVERRIDES}))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert [list(c) for c in dryrun.all_cells("both")] == want["cells"]
    assert len(dryrun.all_cells("single")) == 32
    assert len(want["cells"]) == 64
    assert dryrun.TRAIN_OVERRIDES == want["train"]
    assert dryrun.DEFAULT_TRAIN == want["default"]
    assert dryrun.OPT_OVERRIDES == want["opt"]


# --------------------------------------------------------------- roofline
def test_roofline_and_stage_costs_on_the_h100_table():
    """``tests/test_cost.py``'s cases on the H100's peaks."""
    pk = roofline.PEAK_FLOPS
    assert roofline.HBM_BW == roofline.PEAK_BYTES == 3.35e12
    assert roofline.LINK_BW == 900e9
    base = dict(arch="x", shape="s", mesh="m", n_devices=1,
                raw_flops_per_dev=1e12, raw_bytes_per_dev=1e9,
                flops_per_dev=1e12, bytes_per_dev=1e9,
                collective_bytes_per_dev=0.0, collective_breakdown={})
    r_bf, r_f32, r_i8 = (roofline.Roofline(**base, dtype=d).finalize()
                         for d in ("bf16", "fp32", "int8"))
    assert r_f32.t_compute == pytest.approx(
        r_bf.t_compute * pk["bf16"] / pk["fp32"])
    assert r_i8.t_compute == pytest.approx(
        r_bf.t_compute * pk["bf16"] / pk["int8"])
    assert r_bf.t_memory == pytest.approx(1e9 / 3.35e12)
    assert r_f32.bottleneck == "compute" and r_f32.roofline_fraction == 1.0
    # no SPMD program: no collective term, and the bottleneck ignores it
    r = roofline.Roofline(**{**base, "collective_bytes_per_dev": None,
                             "n_devices": 4, "bytes_per_dev": 1e10}
                          ).finalize()
    assert r.t_collective == 0.0 and r.bottleneck == "memory"
    assert r.useful_ratio == 0.0
    r = roofline.Roofline(**{**base, "collective_bytes_per_dev": 1e12},
                          model_flops=5e11).finalize()
    assert r.bottleneck == "collective"
    assert r.t_collective == pytest.approx(1e12 / 900e9)
    assert r.useful_ratio == pytest.approx(0.5)

    stats = opcount.OpStats(flops=2 * pk["bf16"], hbm_bytes=3.35e12)
    tc, tm, tcol = opcount.stage_cost_features(stats)
    assert tc == pytest.approx(2.0)
    assert tm == pytest.approx(1.0)
    assert tcol == 0.0
    tc2, _, _ = opcount.stage_cost_features(stats, dtype="int8",
                                            n_devices=2)
    assert tc2 == pytest.approx(pk["bf16"] / pk["int8"])


# ---------------------------------------------- the counter against HLO
def _pair(arch, remat):
    jc = dataclasses.replace(jget(arch).reduced(), remat=remat)
    tc = dataclasses.replace(tget(arch).reduced(), remat=remat)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    fwd = hlo.analyze(jax.jit(lambda p, b: jm.forward(p, b)).lower(
        params, jb).compile().as_text(), 1).flops
    grad = hlo.analyze(jax.jit(jax.value_and_grad(jm.loss)).lower(
        params, jb).compile().as_text(), 1).flops
    tm = tbuild(tc, "cpu")
    masters = masters_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    p = tm.init(0)
    with opcount.count_ops(fake=False) as c:
        c.run(lambda b: tm.forward(p, b), tb)
    with opcount.count_ops(fake=True) as g:
        fm = {k: torch.empty_like(v) for k, v in masters.items()}
        g.run(lambda m, b: loss_and_grads(tm, m, b), fm,
              {k: torch.zeros_like(v) for k, v in tb.items()})
    return tc, (fwd, grad), (c.stats.flops, g.stats.flops)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["llama3-8b", "mqrld-embedder-100m"])
def test_counter_flops_match_hlo(arch, remat):
    """The counter's FLOPs (forward live on the CPU, loss + gradient on
    fake tensors) against ``hlo.analyze`` of the reference's compiled
    program, within 0.5%, with block remat counted by both (the
    recomputed forward)."""
    _, (jf, jg), (tf, tg) = _pair(arch, remat)
    assert tf == pytest.approx(jf, rel=5e-3)
    assert tg == pytest.approx(jg, rel=5e-3)
    if remat == "block":
        assert tg > 3 * tf


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_counter_flops_moe_differ_by_the_one_hot_einsums(arch):
    """The reference's MoE dispatches and combines through one-hot
    (b, s, e, cap) einsums (``repro/models/moe.py``), 2 b s e cap d
    FLOPs each a layer; the port gathers and scatters by index. The rest
    is equal: forward = port + 2 einsums a layer, loss + gradient = port +
    5 (the two forward, the dispatch's gradient of x and the combine's
    two gradients)."""
    tc, (jf, jg), (tf, tg) = _pair(arch, "none")
    one = 2.0 * 2 * 32 * tc.num_experts * tmoe.capacity(tc, 32) \
        * tc.d_model * tc.num_layers
    assert jf - tf == pytest.approx(2 * one, rel=5e-3)
    assert jg - tg == pytest.approx(5 * one, rel=5e-3)


# ------------------------------------------------------- the dry run
def _families():
    x = tget("xlstm-1.3b").reduced()
    return [tget("llama3-8b").reduced(), tget("internvl2-1b").reduced(),
            tget("phi3.5-moe-42b-a6.6b").reduced(),
            tget("hymba-1.5b").reduced(),
            dataclasses.replace(x, num_layers=4, slstm_every=2),
            tget("seamless-m4t-medium").reduced()]


def _ref_args(cfg_t, shape, rules_j, over):
    """The reference's per-device argument bytes for the cell, from its
    own abstract trees and specs (the dry run's arguments)."""
    cfg_j = dataclasses.replace(jget(cfg_t.name).reduced(), **{
        f.name: getattr(cfg_t, f.name) for f in dataclasses.fields(cfg_t)})
    m = jbuild(cfg_j, rules_j)
    trees = [(m.abstract(), m.specs())]
    if shape.kind == "train":
        sd = over["state_dtype"]
        trees.append((jopt.adam_abstract(m.abstract(), sd),
                      jopt.adam_specs(m.abstract(), m.specs(), rules_j, sd)))
    if shape.kind == "decode":
        trees.append(m.cache_abstract(shape.global_batch, shape.seq_len))
        tok = m.input_specs(shape)["tokens"]
        trees.append((tok, rules_j.spec_for(tok.shape, ("batch", None))))
    else:
        trees.append((m.input_specs(shape), m.input_shardings(shape)))
    sizes = dict(rules_j.sizes)
    total = 0
    for a, s in trees:
        al = jax.tree.leaves(a)
        sl = jax.tree.leaves(s, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert len(al) == len(sl)
        for x, y in zip(al, sl):
            n = int(np.prod(x.shape))
            for e in y:
                for ax in ((e,) if isinstance(e, str) else (e or ())):
                    n //= sizes[ax]
            total += n * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_every_family_holds_argument_bytes(kind):
    """``dry_run`` on a reduced config of every family: its argument bytes
    on a 2 x 2 mesh equal the reference's specs' sum; on a 1 x 1 mesh
    they equal the bytes of the arguments the port makes (the cache's
    host-int length and hymba's int64 ring positions named); the work is
    split evenly with no collective term; the trace takes the card's
    routes (prefill's attention charged as the flash kernel)."""
    shape = ShapeConfig(kind, 64, 16, kind)
    for cfg in _families():
        over = dryrun.overrides(cfg.name, kind)
        mesh = make_dev_mesh(2, 2)
        res = dryrun.dry_run(cfg, shape, mesh, over)
        j_rules = jpart.rules_for_mesh(
            types.SimpleNamespace(axis_names=mesh.axis_names,
                                  devices=np.empty(mesh.shape)),
            fsdp=cfg.fsdp, fsdp_over_pods=over["fsdp_over_pods"],
            tensor_parallel=over["tensor_parallel"])
        mem = res["memory"]
        assert mem["argument_bytes"] == _ref_args(cfg, shape, j_rules, over)
        assert mem["peak_per_device_bytes"] == mem["argument_bytes"] + \
            mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
        rf = res["roofline"]
        assert rf["split"] == "even" and rf["n_devices"] == 4
        assert rf["collective_bytes_per_dev"] is None
        assert rf["collective_reason"] == dryrun.NO_COLLECTIVES
        assert rf["flops_per_dev"] > 0 and rf["bytes_per_dev"] > 0
        assert res["ops"]["n_ops"] > 0
        if kind == "train":     # the outputs beside the aliased: metrics
            assert mem["alias_bytes"] == mem["output_bytes"] - 12
            assert f"microbatches x {over['microbatches']}" in \
                res["ops"]["trips"]
        attends = cfg.family != "ssm"
        if kind == "prefill":
            assert ("flash_attention" in res["ops"]["kernels"]) == attends
        one = dryrun.dry_run(cfg, shape, make_dev_mesh(1, 1), over)
        prog = dryrun.program(cfg, shape, make_dev_mesh(1, 1), over)
        made = dryrun.make_args(prog, seed=0)
        real = sum(t.numel() * t.element_size()
                   for t in opcount._tensors(_arg_tensors(made)))
        named = 0
        if kind == "decode":
            named = -4                              # length: a host int
            if cfg.family == "hybrid":              # wpos int64, not int32
                named += made[1].wpos.numel() * 4
        assert real == one["memory"]["argument_bytes"] + named
        assert one["roofline"]["collective_bytes_per_dev"] == 0.0
        assert one["roofline"]["split"] == "none"


def _arg_tensors(made):
    out = []
    for a in made:
        if dataclasses.is_dataclass(a):
            out.append([getattr(a, f.name) for f in dataclasses.fields(a)])
        else:
            out.append(a)
    return out


def test_dry_run_sequential_loops_are_weighted():
    """xlstm's sLSTM scan (a captured graph on the card) and mLSTM chunk
    loop count one step times their trips: the prefill's count equals the
    count with every step walked."""
    cfg = _families()[4]
    shape = ShapeConfig("prefill", 64, 2, "prefill")
    prog = dryrun.program(cfg, shape, make_dev_mesh(1, 1),
                          dryrun.overrides(cfg.name, "prefill"))
    weighted, _ = dryrun.trace(prog)
    trips = dict(weighted.trips)
    assert trips["xlstm._run_steps"] == 64 and trips["graph.scan"] == 8
    # walk every step: the counter's two loop stand-ins taken away, so
    # the mLSTM's scan runs as written and the sLSTM's steps one by one
    with opcount.count_ops(fake=True) as c:
        del c.stand_ins["scan"]
        c.stand_ins["_run_steps"] = _walk_steps
        c.run(prog.step, *dryrun.make_args(prog, fake=True))
    assert not c.stats.trips
    assert c.stats.flops == weighted.flops
    assert c.stats.hbm_bytes == pytest.approx(weighted.hbm_bytes, rel=1e-9)
    assert c.stats.n_ops > weighted.n_ops


def _walk_steps(fn, step, n, device, graphed):
    for _ in range(n):
        step()


def test_full_size_cell_traces_without_storage():
    """A full-size cell (llama3-8b decode_32k on the 16 x 16 mesh) traces
    on fake tensors: no storage, in seconds, with the reference's keys."""
    res = dryrun.lower_cell("llama3-8b", "decode_32k", False)
    assert set(res) == {"arch", "shape", "mesh", "n_devices", "trace_s",
                        "memory", "cost_raw", "roofline", "ops"}
    assert res["mesh"] == "16x16" and res["n_devices"] == 256
    assert res["trace_s"] < 60
    assert res["roofline"]["bottleneck"] == "memory"
    assert res["memory"]["alias_bytes"] > 0


def test_run_cells_caches_and_writes_err(tmp_path, monkeypatch, capsys):
    calls = []

    def fake(arch, shape, multi, collect_hlo=True, opt=False):
        calls.append((arch, shape, multi))
        if arch == "bad":
            raise RuntimeError("boom")
        return {"trace_s": 0.0, "memory": {"peak_per_device_bytes": 0},
                "roofline": {"bottleneck": "memory"}}
    monkeypatch.setattr(dryrun, "lower_cell", fake)
    cells = [("a", "train_4k", False), ("bad", "train_4k", True)]
    assert dryrun.run_cells(cells, str(tmp_path)) is False
    assert (tmp_path / "a__train_4k__single.json").exists()
    err = (tmp_path / "bad__train_4k__multi.json.err").read_text()
    assert "RuntimeError: boom" in err
    assert dryrun.run_cells(cells[:1], str(tmp_path)) is True
    assert calls == [cells[0], cells[1]]
    assert "SKIP a__train_4k__single (cached)" in capsys.readouterr().out


def test_every_kernel_entry_point_is_charged_by_its_law():
    """On fake tensors each of ``kernels/ops.py``'s kernel entry points
    returns an empty output of the kernel's shape and is charged by its
    bound law; nothing of the plain version inside is counted."""
    from repro_torch.kernels import ops
    with opcount.count_ops(fake=True) as c:
        q, p = torch.empty(48, 16), torch.empty(300, 16)
        tiles, valid = torch.empty(48, 64, 16), torch.ones(48, 64, dtype=bool)
        codes = torch.empty(48, 64, 16, dtype=torch.int8)
        qkv = torch.empty(2, 128, 4, 64, dtype=torch.bfloat16)

        def calls():
            return (ops.pairwise_sq_l2(q, p), ops.topk_l2(q, p, 5),
                    ops.topk_l2_masked(q, tiles, valid, 7),
                    ops.quant_lb2(q, codes, torch.empty(48, 64),
                                  torch.empty(48, 64), torch.empty(48, 64),
                                  valid, precision="int8"),
                    ops.lpgf_force(p, 1.0, 0.5),
                    ops.flash_attention(qkv, qkv, qkv, causal=True,
                                        window=32))
        d2, (kd, ki), (md, mi), lb, (f, w), o = c.run(calls)
    assert d2.shape == (48, 300) and kd.shape == ki.shape == (48, 5)
    assert md.shape == mi.shape == (48, 7) and lb.shape == (48, 64)
    assert f.shape == (300, 16) and w.shape == (300,)
    assert o.shape == qkv.shape and o.dtype == torch.bfloat16
    k = c.stats.kernels
    assert set(k) == set(opcount.KERNEL_LAWS)
    assert all(v["calls"] == 1 for v in k.values())
    assert k["pairwise_sq_l2"]["flops"] == 2.0 * 48 * 300 * 16
    assert k["flash_attention"]["flops"] == \
        4.0 * 64 * 2 * 4 * opcount.attn_pairs(128, True, 32)
    assert c.stats.flops == sum(v["flops"] for v in k.values())
    assert c.stats.n_ops == 0


def test_counter_stands_in_on_its_own_thread_only():
    """While a fake trace counts, another thread's calls of a kernel entry
    point and of ``on_card`` run as written: real distances, the CPU's
    route, and no counter seen there; the counting thread's call is
    charged once."""
    import threading
    from repro_torch import on_card, op_counter
    from repro_torch.kernels import ops
    q = torch.arange(12.0).reshape(4, 3)
    want = ops.pairwise_sq_l2(q, q)
    seen = {}

    def other():
        seen.update(counter=op_counter(), card=on_card(q),
                    d2=ops.pairwise_sq_l2(q, q))

    def step(x):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        return on_card(x), ops.pairwise_sq_l2(x, x)
    with opcount.count_ops(fake=True) as c:
        card, d2 = c.run(step, torch.empty(4, 3))
    assert card and d2.shape == (4, 4)
    assert seen["counter"] is None and not seen["card"]
    assert torch.equal(seen["d2"], want)
    assert c.stats.kernels["pairwise_sq_l2"]["calls"] == 1
    assert op_counter() is None and not on_card(q)
