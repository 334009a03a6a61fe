"""An open loop of text requests through ``RetrievalServer.submit`` /
``poll`` at a rate fixed in the cell, ``rate`` requests a second.

Every seed offers the same set of sizes and arrivals, in another order:
the gaps between arrivals are the exponential distribution's quantiles
at (i + 1/2) / M for the M requests of the run, the prompt lengths
(``lengths``) and the archetypes (``archetypes``, see ``archetypes.py``;
the vector is the request's embedding) come in equal shares, and the
seed permutes each sequence. A request's prompt is that many tokens of
a topic's prompt (topic drawn from the seed), each redrawn with
probability ``redraw``.

The server: ``RetrievalServer(batch_size, pipeline_depth, precision,
project=unit-normalise)`` over ``EmbeddingServer`` of the configuration's
embedder on the benchmark's weights, driven from one thread. A
request's latency runs from when it was due to the loop seeing its
future resolved, so a stall counts against every request behind it.
``p95_ms`` is over every request due in the window; those still in
flight when it closes are waited for while arrivals go on.

Parameters: ``rate``, ``lengths``, ``redraw``, ``archetypes``,
``batch_size``, ``pipeline_depth``, ``warm_seconds``, ``sample``, and
``trace_seconds`` (a traced run profiles the window's last seconds only:
the profiler's cost stalls the one host loop and builds a backlog, so
the host-clock and program-counter metrics are read over the window
before it starts, and only the kernel shares over the traced tail)."""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from perfbench import archetypes, inputs, program
from perfbench.laws.embedder import forward_flops
from perfbench.reference import bruteforce
from perfbench.reference import embedder as ref_embedder

DRAIN_S = 60.0     # the longest wait for a window's last requests


def _unit(e: np.ndarray) -> np.ndarray:
    e = np.asarray(e, np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def schedule(seed: int, prm: dict, rate: float, total_s: float) -> dict:
    """Due times (s from the loop's start), lengths and archetype indices
    of the run's requests."""
    m = int(math.ceil(rate * total_s))
    r = inputs.rng(seed, 41)
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m) / rate
    return dict(due=np.cumsum(r.permutation(gaps)),
                length=r.permutation(np.resize(prm["lengths"], m)),
                arch=r.permutation(np.resize(
                    np.arange(len(prm["archetypes"])), m)))


def setup(ctx) -> dict:
    from repro_torch.serve.engine import EmbeddingServer, RetrievalServer
    model, prm = ctx.config["embedder"], ctx.params
    world = {"weights": inputs.embedder_weights(model, ctx.seed, ctx.device)}
    table = ctx.table(world)
    p = ctx.platform(table)
    cfg = program.embedder_config(model)
    emb = EmbeddingServer(cfg, program.embedder_params(cfg, world["weights"]),
                          device=None if ctx.device.type == "cuda"
                          else ctx.device)
    rec = ctx.rec
    real_embed = emb.embed

    def embed(tokens):
        with rec.span("embed"):
            out = real_embed(tokens)
        b, s = np.shape(tokens)
        rec.count("embed_flops", forward_flops(model, b, s))
        return out
    emb.embed = embed
    srv = RetrievalServer(p, emb, batch_size=int(prm["batch_size"]),
                          pipeline_depth=int(prm["pipeline_depth"]),
                          precision=ctx.config["precision"], project=_unit)
    col = ctx.config["table"]["column"]
    world.update(table=table, raw=table["vector"][col], platform=p,
                 server=srv)
    t0 = rec.now()
    start(ctx, world, float(prm["rate"]),
          float(prm["warm_seconds"]) + ctx.seconds + DRAIN_S)
    # served closed before the open loop's clock starts: the first
    # requests build the scan's engine (its int8 planes, on the host) and
    # meet every prompt length and archetype
    srv.serve([_request_of(ctx, world, n)
               for n in range(4 * int(prm["batch_size"]))])
    ctx.sync()
    t0 = ctx.stage("warm (closed)", t0)
    start(ctx, world, float(prm["rate"]),
          float(prm["warm_seconds"]) + ctx.seconds + DRAIN_S)
    drive(ctx, world, float(prm["warm_seconds"]))
    ctx.stage("warm (open)", t0)
    return world


def start(ctx, world, rate: float, total_s: float) -> None:
    """Begin a run of the loop at ``rate``: its schedule and clock."""
    world.update(sched=schedule(ctx.seed, ctx.params, rate, total_s),
                 t_start=ctx.rec.now(), sent=0, outstanding={}, done=[],
                 late=[])


def _request(ctx, world, n: int):
    """Request ``n`` of the run: (archetype, tokens)."""
    model, sched = ctx.config["embedder"], world["sched"]
    r = inputs.rng(ctx.seed, 40, n)
    prompts = world["topic_prompts"]
    length = int(sched["length"][n])
    toks = prompts[int(r.integers(0, len(prompts))), :length].copy()
    redo = r.random(length) < float(ctx.params["redraw"])
    toks[redo] = r.integers(0, model["vocab_size"], int(redo.sum()))
    return ctx.params["archetypes"][int(sched["arch"][n])], toks


def _request_of(ctx, world, n: int):
    """Request ``n`` as the program's ``RetrievalRequest``."""
    from repro_torch.core import query as Q
    from repro_torch.serve.engine import RetrievalRequest
    arch, toks = _request(ctx, world, n)
    col = ctx.config["table"]["column"]
    vk = next(p for p in arch if p[0] == "vk")
    pred = [archetypes.program_query(Q, [p], col, None) for p in arch
            if p[0] == "nr"]
    return RetrievalRequest(
        tokens=toks, attr=col, k=int(vk[1]),
        predicate=None if not pred else
        (pred[0] if len(pred) == 1 else Q.And.of(*pred)))


def _send(ctx, world, n: int, due: float) -> None:
    req = _request_of(ctx, world, n)
    with ctx.rec.span("submit"):
        world["late"].append(ctx.rec.now() - due)
        fut = world["server"].submit(req)
    world["outstanding"][fut] = (n, due)


def drive(ctx, world, until_s: float, wait_for=None) -> None:
    """Send every request as it falls due and serve, until ``until_s``
    after the loop's start and, if given, until ``wait_for()`` is true."""
    rec, srv, out = ctx.rec, world["server"], world["outstanding"]
    due, t_start = world["sched"]["due"], world["t_start"]
    while True:
        rec.tick()
        now = rec.now()
        while world["sent"] < len(due) and \
                t_start + due[world["sent"]] <= now:
            n = world["sent"]
            world["sent"] += 1
            _send(ctx, world, n, t_start + due[n])
        if out:
            with rec.span("poll"):
                srv.poll()
        now = rec.now()
        for fut in [f for f in out if f.done()]:
            n, t_due = out.pop(fut)
            world["done"].append((n, t_due, now, fut.result()))
        if now - t_start >= until_s and (wait_for is None or wait_for()):
            return
        if not out and world["sent"] < len(due):
            time.sleep(max(0.0, min(0.002, t_start + due[world["sent"]]
                                    - rec.now())))


def window(ctx, world) -> None:
    rec, srv = ctx.rec, world["server"]
    rec.gauge("served", lambda: srv.stats()["served"])
    rec.gauge("chunks", lambda: srv.stats()["batches"])
    world["late"] = []
    w0 = rec.start_window() - world["t_start"]
    n_done = len(world["done"])
    drive(ctx, world, w0 + ctx.seconds)
    rec.end_window()
    due = world["sched"]["due"]
    in_win = set(np.nonzero((due >= w0) & (due < w0 + ctx.seconds))[0])
    in_time = {d[0] for d in world["done"][n_done:]}
    drive(ctx, world, 0.0, wait_for=lambda: in_win <= {
        d[0] for d in world["done"][n_done:]} or
        rec.now() - rec.t1 > DRAIN_S)
    done = [d for d in world["done"][n_done:] if d[0] in in_win]
    world["window_done"] = done
    lat = np.array([d[2] - d[1] for d in done], np.float64)
    late = np.array(world["late"])
    ctx.attempted = len(in_win)
    ctx.failed = len(in_win) - len(done) + sum(d[3].shed for d in done)
    ctx.e2e["p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    print(f"window: {len(in_win)} requests due, {len(in_time & in_win)} "
          f"resolved inside it; latency ms p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} p95 "
          f"{ctx.e2e['p95_ms']:.1f} p99 {np.percentile(lat, 99) * 1e3:.1f}"
          f"; sent late by ms p95 {np.percentile(late, 95) * 1e3:.2f} max "
          f"{late.max() * 1e3:.2f}", file=sys.stderr)
    srv.flush()


def evidence(ctx, world) -> dict:
    """A sample, drawn from the seed, of the requests due in the window:
    each prompt, the program's query vector and rows (as logical ids)."""
    from perfbench.harness import physical_to_logical
    done, col = world["window_done"], ctx.config["table"]["column"]
    take = inputs.rng(ctx.seed, 30).choice(
        len(done), min(len(done), int(ctx.params["sample"])), replace=False)
    view = world["platform"].view()
    items, relabelled = [], 0
    for t in sorted(take):
        n, _, _, res = done[int(t)]
        arch, toks = _request(ctx, world, n)
        logical, same = physical_to_logical(
            view.row_ids, view.vector[col], view.numeric, world["raw"],
            world["table"]["numeric"], res.rows)
        relabelled += not same
        items.append(dict(arch=arch, tokens=toks, vec=_vk_vector(res.query),
                          rows=logical, shed=res.shed))
    return dict(raw=world["raw"], numeric=world["table"]["numeric"],
                weights=world["weights"], items=items, relabelled=relabelled)


def _vk_vector(q) -> np.ndarray:
    """The query vector of the request's V.K (alone or in an And)."""
    nodes = [q] if not hasattr(q, "parts") else list(q.parts)
    return next(np.asarray(p.query, np.float32) for p in nodes
                if type(p).__name__ == "VK")


def reference_vectors(ev, model: dict, device, mm=None) -> np.ndarray:
    """Unit embeddings of the sampled prompts by the reference's forward
    (equal-length prompts together, as a batch changes no row)."""
    wf = {k: v.float() for k, v in ev["weights"].items()}
    ref_embedder.ieee_fp32()
    out = [None] * len(ev["items"])
    for s in sorted({len(it["tokens"]) for it in ev["items"]}):
        idx = [i for i, it in enumerate(ev["items"])
               if len(it["tokens"]) == s]
        toks = torch.as_tensor(np.stack([ev["items"][i]["tokens"]
                                         for i in idx]), device=device)
        e = _unit(ref_embedder.pooled(wf, toks, model, mm=mm).cpu().numpy())
        for j, i in enumerate(idx):
            out[i] = e[j]
    return np.stack(out)


def check(ctx, ev) -> dict:
    items = ev["items"]
    ref = reference_vectors(ev, ctx.config["embedder"], ctx.device)
    got = np.stack([it["vec"] for it in items])
    gap = float(np.linalg.norm(got - ref, axis=1).max())
    queries = [archetypes.reference_query(it["arch"], it["vec"])
               for it in items]
    verdicts = bruteforce.judge_all(ev["raw"], ev["numeric"], queries,
                                    [it["rows"] for it in items],
                                    [True] * len(items))
    bruteforce.report(verdicts, ev["relabelled"])
    print(f"query vectors: widest distance from the reference's "
          f"{gap!r} over {len(items)}", file=sys.stderr)
    return {"mismatched_requests": sum(v is not None for v in verdicts)
            + ev["relabelled"] + sum(it["shed"] for it in items),
            "query_vector_gap": gap}


def _first(ctx, world) -> list:
    """The first ``sample`` requests of the seed's run."""
    rate, n = float(ctx.params["rate"]), int(ctx.params["sample"])
    world["sched"] = schedule(ctx.seed, ctx.params, rate, n / rate)
    return [dict(zip(("arch", "tokens"), _request(ctx, world, i)))
            for i in range(n)]


def control(ctx) -> dict:
    """The control's readings at the cell's size: the first ``sample``
    requests answered by the reference with its embedder's products in
    fp8 and its scan over int4 rows (``reference/controls.py``)."""
    from perfbench.reference import controls
    model = ctx.config["embedder"]
    world = {"weights": inputs.embedder_weights(model, ctx.seed, ctx.device)}
    table = ctx.table(world)
    raw = table["vector"][ctx.config["table"]["column"]]
    ev = {"weights": world["weights"], "items": _first(ctx, world)}
    ref = reference_vectors(ev, model, ctx.device)
    low = reference_vectors(ev, model, ctx.device, mm=controls.fp8_mm)
    queries = [archetypes.reference_query(it["arch"], v)
               for it, v in zip(ev["items"], low)]
    rows = controls.control_rows(
        queries, raw, table["numeric"], device=ctx.device,
        precision=controls.BELOW[ctx.config["precision"]])
    verdicts = bruteforce.judge_all(raw, table["numeric"], queries, rows,
                                    [True] * len(queries))
    return {"mismatched_requests": sum(v is not None for v in verdicts),
            "query_vector_gap": float(np.linalg.norm(low - ref,
                                                     axis=1).max())}


def sound(ctx) -> dict:
    """The program's embedder on the first ``sample`` requests' prompts
    (equal lengths together, as the server buckets them), against the
    reference: the gap the harness compares, without the rest of a run."""
    from repro_torch.serve.engine import EmbeddingServer
    model = ctx.config["embedder"]
    world = {"weights": inputs.embedder_weights(model, ctx.seed, ctx.device)}
    ctx.table(world)
    ev = {"weights": world["weights"], "items": _first(ctx, world)}
    cfg = program.embedder_config(model)
    emb = EmbeddingServer(cfg, program.embedder_params(cfg, world["weights"]),
                          device=None if ctx.device.type == "cuda"
                          else ctx.device)
    got = np.zeros((len(ev["items"]), model["d_model"]), np.float32)
    for s in sorted({len(it["tokens"]) for it in ev["items"]}):
        idx = [i for i, it in enumerate(ev["items"])
               if len(it["tokens"]) == s]
        got[idx] = _unit(emb.embed(np.stack([ev["items"][i]["tokens"]
                                             for i in idx])))
    ref = reference_vectors(ev, model, ctx.device)
    return {"query_vector_gap": float(np.linalg.norm(got - ref,
                                                     axis=1).max())}


def sweep(ctx, world, rates, seconds: float) -> list:
    """The loop at each of ``rates`` in turn on one set-up system: per
    rate, requests due in ``seconds`` and resolved within them, their
    p95 latency, and the backlog left at the close."""
    out = []
    for rate in rates:
        start(ctx, world, rate, seconds + DRAIN_S)
        drive(ctx, world, seconds)
        lat = np.array([d[2] - d[1] for d in world["done"]])
        out.append(dict(rate=rate, due=int(np.sum(
            world["sched"]["due"] < seconds)), resolved=len(world["done"]),
            resolved_per_s=len(world["done"]) / seconds,
            p50_ms=float(np.percentile(lat, 50)) * 1e3,
            p95_ms=float(np.percentile(lat, 95)) * 1e3,
            backlog=len(world["outstanding"])))
        print(json.dumps(out[-1]), flush=True)
        world["server"].flush()
    return out
