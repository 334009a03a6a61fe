"""Back-to-back batches of hybrid queries through
``MQRLD.session().plan(batch).execute()``: a closed loop of one batch
client. Each batch holds ``batch`` fresh queries by example (table rows
drawn from the seed), the archetypes coming round-robin. A V.R radius
comes from the data: the median ``radius_rank``-th-neighbour distance of
``radius_sample`` rows drawn from the seed, to 4 significant digits.

Parameters: ``batch``, ``archetypes`` (see ``archetypes.py``),
``warm_batches``, ``radius_sample``, ``radius_rank``, ``sample`` (answers
held to the reference)."""
from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench import archetypes, inputs
from perfbench.reference import bruteforce


def _radius(ctx, raw: np.ndarray) -> float:
    x = torch.as_tensor(raw, device=ctx.device)
    pick = inputs.rng(ctx.seed, 4).choice(
        len(raw), ctx.params["radius_sample"], replace=False)
    d = torch.cdist(x[torch.as_tensor(pick, device=ctx.device)], x)
    kth = d.kthvalue(int(ctx.params["radius_rank"]) + 1, dim=1).values
    return float(f"{float(kth.median()):.4g}")


def setup(ctx) -> dict:
    world = {}
    table = ctx.table(world)
    raw = table["vector"][ctx.config["table"]["column"]]
    radius = _radius(ctx, raw)
    p = ctx.platform(table)
    world.update(table=table, raw=raw, radius=radius, platform=p,
                 session=p.session(precision=ctx.config["precision"]),
                 answers=[])
    t0 = ctx.rec.now()
    for i in range(int(ctx.params["warm_batches"])):
        _batch(ctx, world, -1 - i)
    ctx.stage("warm", t0)
    return world


def _draw(ctx, world, i: int) -> np.ndarray:
    n = len(world["raw"])
    return inputs.rng(ctx.seed, 20, i).integers(0, n, ctx.params["batch"])


def _batch(ctx, world, i: int):
    """Batch ``i`` (warm batches count down from -1): its query rows,
    answers and stats."""
    from repro_torch.core import query as Q
    rec, arch = ctx.rec, ctx.params["archetypes"]
    col = ctx.config["table"]["column"]
    with rec.span("make"):
        idx = _draw(ctx, world, i)
        qs = [archetypes.program_query(Q, arch[j % len(arch)], col,
                                       world["raw"][r], world["radius"])
              for j, r in enumerate(idx)]
    with rec.span("plan"):
        plan = world["session"].plan(qs)
    with rec.span("execute"):
        rows, stats = plan.execute()
    return idx, rows, stats


def window(ctx, world) -> None:
    rec = ctx.rec
    t0 = rec.start_window()
    i, ends = 0, []
    while True:
        idx, rows, stats = _batch(ctx, world, i)
        world["answers"].append((i, rows))
        ends.append(rec.now() - t0)
        rec.tick()
        rec.count("batches")
        rec.count("queries", stats.queries)
        rec.count("rows_scanned", stats.rows_scanned)
        rec.count("knn_rounds", stats.knn_rounds)
        i += 1
        if rec.now() - t0 >= ctx.seconds:
            break
    rec.end_window()
    print("window: batches end at " + " ".join(f"{t:.3f}" for t in ends),
          file=sys.stderr)
    n = i * int(ctx.params["batch"])
    ctx.attempted = n
    ctx.failed = n - sum(len(r) for _, r in world["answers"])
    ctx.e2e["qps"] = n / rec.window_s


def evidence(ctx, world) -> dict:
    """A sample of the window's answers, drawn from the seed, as logical
    row ids, beside the raw table and the queries rebuilt from it."""
    p, b = world["platform"], int(ctx.params["batch"])
    arch, col = ctx.params["archetypes"], ctx.config["table"]["column"]
    total = len(world["answers"]) * b
    take = inputs.rng(ctx.seed, 30).choice(
        total, min(total, int(ctx.params["sample"])), replace=False)
    view = p.view()
    queries, answers, ordered, honest = [], [], [], 0
    for t in sorted(take):
        i, j = divmod(int(t), b)
        bi, rows = world["answers"][i]
        r = int(_draw(ctx, world, bi)[j])
        a = arch[j % len(arch)]
        logical, same = _logical(view, world, rows[j], col)
        honest += not same
        queries.append(archetypes.reference_query(a, world["raw"][r],
                                                  world["radius"]))
        answers.append(logical)
        ordered.append(archetypes.top_level_vk(a))
    return dict(raw=world["raw"], numeric=world["table"]["numeric"],
                queries=queries, answers=answers, ordered=ordered,
                relabelled=honest)


def _logical(view, world, rows, col):
    from perfbench.harness import physical_to_logical
    return physical_to_logical(view.row_ids, view.vector[col], view.numeric,
                               world["raw"], world["table"]["numeric"], rows)


def check(ctx, ev) -> dict:
    verdicts = bruteforce.judge_all(ev["raw"], ev["numeric"], ev["queries"],
                                    ev["answers"], ev["ordered"])
    bruteforce.report(verdicts, ev["relabelled"])
    return {"mismatched_queries": sum(v is not None for v in verdicts)
            + ev["relabelled"]}


def control(ctx) -> dict:
    """The control's readings at the cell's size: a batch's sampled
    queries answered by the reference with its distances one precision
    below the configuration's (``reference/controls.py``)."""
    from perfbench.reference import controls
    table = ctx.table({})
    raw = table["vector"][ctx.config["table"]["column"]]
    radius = _radius(ctx, raw)
    arch, b = ctx.params["archetypes"], int(ctx.params["batch"])
    idx = inputs.rng(ctx.seed, 20, 0).integers(0, len(raw), b)
    take = sorted(inputs.rng(ctx.seed, 30).choice(
        b, min(b, int(ctx.params["sample"])), replace=False))
    queries = [archetypes.reference_query(arch[j % len(arch)], raw[idx[j]],
                                          radius) for j in take]
    rows = controls.control_rows(
        queries, raw, table["numeric"], device=ctx.device,
        precision=controls.BELOW[ctx.config["precision"]])
    verdicts = bruteforce.judge_all(
        raw, table["numeric"], queries, rows,
        [archetypes.top_level_vk(arch[j % len(arch)]) for j in take])
    return {"mismatched_queries": sum(v is not None for v in verdicts)}
