"""Dry run: every (arch x shape x mesh) cell's memory and roofline, traced
on the CPU (port of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell for a 16 x 16 (or 2 x 16 x
16) mesh of placeholder devices and reads XLA's memory analysis, cost
analysis and SPMD HLO. The port has no SPMD partitioner and no HLO, so
its counterpart answers the same questions this way:

- The mesh is logical (``launch/mesh.py``): axis names and sizes, read
  by ``rules_for_mesh`` and the spec functions exactly as the reference
  reads its mesh.
- The bytes the specs fix are exact: ``argument_bytes``, ``output_bytes``
  and ``alias_bytes`` (what the reference donates: the parameters and
  optimizer state in train, the cache in decode). Each leaf's abstract
  shape is divided along the mesh axes of its partition spec, times its
  type's bytes. The step's arguments are the reference's: fp32 masters
  (prefill and decode cast them to the serving types inside the step,
  as the reference's program casts its fp32 parameters), the optimizer
  state, the batch, the cache.
- The step's work comes from a trace of the port's own
  ``make_train_step``, ``make_prefill_step`` or ``make_decode_step`` on
  fake tensors (``utils/opcount.py``): FLOPs and HBM bytes, kernels
  charged by their own law, sequential loops weighted by their trip
  count, and the peak of the live bytes beyond the arguments. That peak
  less the outputs no argument gives back (output - alias) is
  ``temp_bytes``, so ``argument + temp + output - alias``, the
  reference's ``peak_per_device_bytes``, is the port's peak.
- Meshes of more than one device: FLOPs, bytes and temp bytes per device
  are the traced global program's divided evenly across the devices, as
  the reference's ``stage_cost_features`` divides them (``"split":
  "even"``). ``collective_bytes_per_dev`` is None, with the reason: no
  SPMD program exists on one card, so the bottleneck is taken over
  compute and memory only. A one-device mesh runs no collective (0).

Nothing is placed on a device, as in the reference. ``chip_smoke.py``
holds the predictions of a cut cell (``dry_run`` on
``make_dev_mesh(1, 1)``) against the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import (SHAPES_BY_NAME, ShapeConfig, TrainConfig,
                                 all_configs, get_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import spec as S
from repro_torch.models.transformer import torch_dtype
from repro_torch.models.zoo import build_model, params_from_masters
from repro_torch.sharding.partitioning import P, rules_for_mesh
from repro_torch.train.optimizer import adam_abstract, adam_specs
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)
from repro_torch.utils import opcount
from repro_torch.utils.roofline import Roofline, model_flops_for

# Per-arch dry-run overrides: microbatch counts sized so activations fit,
# and optimizer/FSDP settings sized so arctic fits a pod.
TRAIN_OVERRIDES = {
    "arctic-480b": dict(microbatches=16, state_dtype="int8",
                        fsdp_over_pods=True),
    "phi3.5-moe-42b-a6.6b": dict(microbatches=8, state_dtype="bfloat16"),
    "llama3-8b": dict(microbatches=4, state_dtype="float32"),
    "yi-9b": dict(microbatches=4, state_dtype="float32"),
    "deepseek-7b": dict(microbatches=4, state_dtype="float32"),
}
DEFAULT_TRAIN = dict(microbatches=2, state_dtype="float32",
                     fsdp_over_pods=False, tensor_parallel=True, cfg={})

# The reference's optimization variants (--opt), copied: the
# tensor_parallel=False variants are sized for the single-pod mesh.
OPT_OVERRIDES = {
    "olmo-1b": dict(microbatches=1, tensor_parallel=False),
    "arctic-480b": dict(microbatches=16, state_dtype="int8",
                        fsdp_over_pods=True,
                        cfg=dict(moe_shard="ff2")),
    "xlstm-1.3b": dict(cfg=dict(mlstm_chunk=256)),
    "deepseek-7b": dict(microbatches=1, tensor_parallel=False),
    "llama3-8b": dict(microbatches=1, tensor_parallel=False),
    "yi-9b": dict(microbatches=1, tensor_parallel=False),
    "seamless-m4t-medium": dict(microbatches=8),
    "hymba-1.5b": dict(microbatches=8),
    "xlstm-1.3b__train": dict(microbatches=4, cfg=dict(mlstm_chunk=256)),
}

_ROOFLINE_DTYPE = {"bfloat16": "bf16", "float32": "fp32"}
NO_COLLECTIVES = ("no SPMD program exists on one card: the per-device "
                  "program and its collectives wait for a machine with "
                  "more than one card")


def overrides(arch: str, kind: str, opt: bool = False) -> Dict[str, Any]:
    over = {**DEFAULT_TRAIN, **TRAIN_OVERRIDES.get(arch, {})}
    if opt:
        over.update(OPT_OVERRIDES.get(arch, {}))
        over.update(OPT_OVERRIDES.get(f"{arch}__{kind}", {}))
    return over


def mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape))


# ---------------------------------------------------------------------------
# A cell's program: its step, abstract arguments and outputs, their specs
# ---------------------------------------------------------------------------
@dataclass
class Program:
    cfg: Any
    shape: ShapeConfig
    model: Any
    step: Callable
    args_abs: Tuple[Any, ...]
    args_specs: Tuple[Any, ...]
    out_abs: Any
    out_specs: Any
    donated: Tuple[bool, ...]     # which arguments the reference donates
    state_dtype: str = "float32"


def _flat(tree: Dict[str, Any]) -> Dict[str, Any]:
    """{path: leaf} of a nested dict in ``iter_defs`` order."""
    out: Dict[str, Any] = {}

    def walk(t, prefix):
        for k in sorted(t):
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(t[k], dict):
                walk(t[k], path)
            else:
                out[path] = t[k]
    walk(tree, "")
    return out


def program(cfg, shape: ShapeConfig, mesh, over: Dict[str, Any],
            device="cpu") -> Program:
    """The step of ``shape.kind`` for ``cfg`` on ``mesh`` under the
    overrides ``over`` (``overrides``), with the reference's arguments and
    outputs: train (masters, AdamState, batch) -> (masters, AdamState,
    metrics); prefill (masters, batch) -> (logits, cache); decode
    (masters, cache, tokens) -> (logits, cache)."""
    if over.get("cfg"):
        cfg = dataclasses.replace(cfg, **over["cfg"])
    rules = rules_for_mesh(mesh, fsdp=cfg.fsdp,
                           fsdp_over_pods=over["fsdp_over_pods"],
                           tensor_parallel=over.get("tensor_parallel", True))
    model = build_model(cfg, device, rules=rules, mesh=mesh)
    p_abs, p_spec = _flat(model.abstract()), _flat(model.specs())
    batch_abs = model.input_specs(shape)
    batch_spec = model.input_shardings(shape)
    b = shape.global_batch
    logits_abs = S.TensorSpec((b, 1, cfg.padded_vocab()),
                              torch_dtype(cfg.dtype))
    logits_spec = rules.spec_for(logits_abs.shape, ("batch", None, "vocab"))
    sd = over["state_dtype"]
    if shape.kind == "train":
        tc = TrainConfig(microbatches=over["microbatches"])
        opt_abs = adam_abstract(p_abs, sd)
        opt_spec = adam_specs(p_abs, p_spec, rules, sd)
        metrics_abs = {"loss": S.TensorSpec((), torch.float32),
                       "grad_norm": S.TensorSpec((), torch.float32),
                       "step": S.TensorSpec((), torch.int32)}
        return Program(
            cfg, shape, model, make_train_step(model, tc, state_dtype=sd),
            (p_abs, opt_abs, batch_abs), (p_spec, opt_spec, batch_spec),
            (p_abs, opt_abs, metrics_abs),
            (p_spec, opt_spec, {k: P() for k in metrics_abs}),
            (True, True, False), sd)
    cache_abs, cache_spec = model.cache_abstract(b, shape.seq_len)
    if shape.kind == "prefill":
        inner = make_prefill_step(model, shape.seq_len)

        def prefill(masters, batch):
            return inner(params_from_masters(cfg, masters), batch)
        return Program(cfg, shape, model, prefill, (p_abs, batch_abs),
                       (p_spec, batch_spec), (logits_abs, cache_abs),
                       (logits_spec, cache_spec), (False, False))
    inner = make_decode_step(model)

    def decode(masters, cache, tokens):
        return inner(params_from_masters(cfg, masters), cache, tokens)
    tok_abs = batch_abs["tokens"]
    tok_spec = rules.spec_for(tok_abs.shape, ("batch", None))
    return Program(cfg, shape, model, decode, (p_abs, cache_abs, tok_abs),
                   (p_spec, cache_spec, tok_spec), (logits_abs, cache_abs),
                   (logits_spec, cache_spec), (False, True, False))


# ---------------------------------------------------------------------------
# Bytes the specs fix
# ---------------------------------------------------------------------------
def spec_leaves(tree) -> list:
    """The ``TensorSpec`` or ``P`` leaves of a tree of dicts (keys sorted),
    tuples and dataclasses (fields in order; a None field, such as a
    cache's ``graph``, is no leaf)."""
    if isinstance(tree, (S.TensorSpec, P)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in spec_leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in spec_leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def leaf_bytes(abstract, spec, sizes: Dict[str, int]) -> int:
    """One device's bytes of a leaf: its shape divided along the mesh axes
    its spec names, times its type's bytes."""
    n = math.prod(abstract.shape)
    for entry in spec:
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= sizes[ax]
    return n * torch.empty((), dtype=abstract.dtype).element_size()


def tree_bytes(abstract, spec, mesh) -> int:
    """One device's bytes of a tree: ``leaf_bytes`` summed."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    a, s = spec_leaves(abstract), spec_leaves(spec)
    if len(a) != len(s):
        raise ValueError(f"{len(a)} abstract leaves against {len(s)} specs")
    return sum(leaf_bytes(x, y, sizes) for x, y in zip(a, s))


# ---------------------------------------------------------------------------
# Arguments: fake (the trace) or seeded on a device (the card)
# ---------------------------------------------------------------------------
def make_args(prog: Program, seed: int = 0, fake: bool = False):
    """The step's arguments on the program's device: masters by the init
    law (seeded), a zero optimizer state, a seeded batch and a cache of
    the port's own types whose length is the shape's last position.
    ``fake`` (under a ``FakeTensorMode``): empty masters and a zero
    batch, no generator drawn."""
    from repro_torch.train.optimizer import init_adam
    shape, model = prog.shape, prog.model
    dev = model.device
    if fake:
        masters = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                   for k, v in prog.args_abs[0].items()}
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in model.input_specs(shape).items()}
    else:
        masters = model.init_masters(seed)
        batch = model.make_batch(shape, seed + 1)
    if shape.kind == "train":
        return masters, init_adam(masters, prog.state_dtype), batch
    if shape.kind == "prefill":
        return masters, batch
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cache.length = shape.seq_len - 1
    return masters, cache, batch["tokens"]


# ---------------------------------------------------------------------------
# The dry run of one cell
# ---------------------------------------------------------------------------
def trace(prog: Program, counter_cls=None
          ) -> Tuple[opcount.OpStats, float]:
    """(the count of the step on fake tensors, seconds it took), counted
    by ``counter_cls`` (``opcount.count_ops``'s)."""
    t0 = time.time()
    with opcount.count_ops(fake=True, counter_cls=counter_cls) as counter:
        args = make_args(prog, fake=True)
        out = counter.run(prog.step, *args)
        del out, args
    return counter.stats, time.time() - t0


def dry_run(cfg, shape: ShapeConfig, mesh, over: Optional[Dict] = None,
            count: bool = True, arch: Optional[str] = None,
            counter_cls=None) -> Dict[str, Any]:
    """The reference's result for ``cfg`` at ``shape`` on ``mesh``:
    memory per device, the count and its roofline. ``count=False`` skips
    the roofline, as the reference's ``--no-hlo`` does; the trace still
    runs for ``temp_bytes``. ``counter_cls``: the trace's counter class
    (``opcount.count_ops``)."""
    over = over if over is not None else overrides(cfg.name, shape.kind)
    prog = program(cfg, shape, mesh, over)
    n_dev = mesh.size
    arg_b = sum(tree_bytes(a, s, mesh)
                for a, s in zip(prog.args_abs, prog.args_specs))
    out_b = tree_bytes(prog.out_abs, prog.out_specs, mesh)
    alias_b = sum(tree_bytes(a, s, mesh) for a, s, d in zip(
        prog.args_abs, prog.args_specs, prog.donated) if d)
    stats, trace_s = trace(prog, counter_cls)
    temp_b = max(0, int(stats.peak_bytes) // n_dev - (out_b - alias_b))
    result = {
        "arch": arch or cfg.name, "shape": shape.name,
        "mesh": mesh_name(mesh), "n_devices": int(n_dev),
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": temp_b, "alias_bytes": alias_b,
            "peak_per_device_bytes": arg_b + temp_b + out_b - alias_b,
        },
        "cost_raw": {"flops": stats.raw_flops / n_dev,
                     "bytes accessed": stats.raw_bytes / n_dev},
    }
    if count:
        coll = 0.0 if n_dev == 1 else None
        rf = Roofline(
            arch=result["arch"], shape=shape.name, mesh=result["mesh"],
            n_devices=int(n_dev),
            raw_flops_per_dev=stats.raw_flops / n_dev,
            raw_bytes_per_dev=stats.raw_bytes / n_dev,
            flops_per_dev=stats.flops / n_dev,
            bytes_per_dev=stats.hbm_bytes / n_dev,
            collective_bytes_per_dev=coll,
            collective_breakdown=dict(stats.collective_bytes),
            model_flops=model_flops_for(prog.cfg, shape),
            memory_per_dev_bytes=result["memory"]["peak_per_device_bytes"],
            dtype=_ROOFLINE_DTYPE.get(prog.cfg.dtype, "bf16"),
            split="even" if n_dev > 1 else "none",
            collective_reason="" if n_dev == 1 else NO_COLLECTIVES,
        ).finalize()
        result["roofline"] = rf.to_dict()
        result["ops"] = {
            "n_ops": stats.n_ops, "n_ops_weighted": stats.n_ops_weighted,
            "trips": sorted({f"{w} x {n}" for w, n in stats.trips}),
            "max_trip": max((n for _, n in stats.trips), default=1),
            "kernels": stats.kernels,
            "collective_counts": stats.collective_counts,
            "peak_bytes": int(stats.peak_bytes),
        }
    return result


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               collect_hlo: bool = True, opt: bool = False):
    """The reference's entry point: ``dry_run`` of a registered cell on
    the production mesh (``collect_hlo``: count the roofline)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    return dry_run(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                   overrides(arch, shape.kind, opt), count=collect_hlo,
                   arch=arch)


def run_cells(cells, out_dir: str, collect_hlo: bool = True,
              opt: bool = False) -> bool:
    """Each cell's JSON into ``out_dir`` (a cached one is skipped; a
    failure writes ``<tag>.json.err`` with its traceback). True when no
    cell failed."""
    os.makedirs(out_dir, exist_ok=True)
    ok = True
    for arch, shape_name, multi in cells:
        tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            print(f"SKIP {tag} (cached)")
            continue
        print(f"RUN  {tag} ...", flush=True)
        try:
            res = lower_cell(arch, shape_name, multi, collect_hlo, opt=opt)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            rl = res.get("roofline", {})
            print(f"  ok trace={res['trace_s']}s "
                  f"mem/dev={res['memory']['peak_per_device_bytes']/2**30:.2f}"
                  f"GiB bottleneck={rl.get('bottleneck', '?')}", flush=True)
        except Exception as e:  # noqa: BLE001
            ok = False
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"  FAIL {type(e).__name__}: {e}", flush=True)
    return ok


def all_cells(mesh_mode: str):
    cells = []
    multis = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh_mode]
    for name, cfg in sorted(all_configs().items()):
        if name == "mqrld-embedder-100m":
            continue  # paper workload exercised by examples, not the grid
        for sh in cfg.shape_cells():
            for m in multis:
                cells.append((name, sh.name, m))
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-count", action="store_true",
                    help="skip the roofline (the trace still runs for "
                    "temp_bytes)")
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's optimization overrides")
    args = ap.parse_args()

    if args.all:
        cells = all_cells(args.mesh)
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        multis = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
        cells = [(args.arch, args.shape, m) for m in multis]
    ok = run_cells(cells, args.out, collect_hlo=not args.no_count,
                   opt=args.opt)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
