"""Retrieval serving: batched rich hybrid queries against a prepared
platform + LM generation serving for the answer text — both engines of a
production deployment. The retrieval half runs end-to-end through the
MOAPI v2 planned path: EmbeddingServer -> RetrievalServer ->
MQRLD.session().plan().execute() -> the beam rounds' masked top-k scans
(the ``topk_l2_masked`` kernel on the card), with the plan cache and
QBS-seeded beam widths amortizing planning across same-shaped request
batches (plan.explain() shows the chosen paths).

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \\
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import query as Q
from repro_torch.core.index import BatchedExecutor
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.serve.engine import (EmbeddingServer, GenRequest,
                                      RetrievalRequest, RetrievalServer,
                                      ServeEngine)


ROWS = 20000            # rows of the catalog

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d = ROWS, 32
    centers = rng.normal(size=(12, d)).astype(np.float32) * 6
    cat = rng.integers(0, 12, n)
    vec = (centers[cat] + rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    table = (MMOTable("catalog").add_vector("v", vec)
             .add_numeric("price", price))
    p = MQRLD(table, qbs_sample=0.2, seed=0, device=dev)
    rep = p.prepare(min_leaf=64, max_leaf=1024)
    print(f"platform ready: {n} MMOs, {rep.n_leaves} buckets")
    out = dict(table=table, n_leaves=rep.n_leaves, row_ids=p.view().row_ids)

    # -------- batched KNN serving through the leaf-ranked executor on the
    # card (the query block is built on the host, moved by knn())
    bat = BatchedExecutor(p.tree, p.enhanced, device=dev)
    queries = p.enhanced[rng.integers(0, n, 64)] + \
        rng.normal(size=(64, p.enhanced.shape[1])).astype(np.float32) * 0.1
    queries = queries.astype(np.float32)
    t0 = time.time()
    dists, rows, stats = bat.knn(queries, 10)
    dt = time.time() - t0
    print(f"batched KNN: 64 queries x top-10 in {dt*1e3:.1f} ms "
          f"({dt/64*1e6:.0f} us/query), buckets touched {stats.buckets_touched}")
    out.update(knn_queries=queries, knn_rows=rows, knn_dists=dists,
               enhanced=p.enhanced, knn_ms=dt * 1e3)

    # -------- batched rich hybrid queries through the MOAPI v2 planner
    sess = p.session()
    hybrid = [Q.And.of(Q.NR("price", 25, 75),
                       Q.VK.of("v", table.vector["v"][i], 5))
              for i in rng.integers(0, n, 64)]
    plan = sess.plan(hybrid)   # cold: normalize + group + compile shapes
    plan.execute()
    t0 = time.time()
    plan = sess.plan(hybrid)   # warm: cached LogicalPlan, QBS-seeded beams
    results, est = plan.execute()
    dt = time.time() - t0
    ex = plan.explain()
    print(f"engine: 64 hybrid queries in {dt*1e3:.1f} ms "
          f"({dt/64*1e6:.0f} us/query), {est.knn_rounds} beam rounds, "
          f"{est.rows_scanned} rows scanned")
    groups = [(g['archetype'], g['beam_seed']) for g in ex['knn_groups']]
    print(f"plan: cache={ex['cache']} paths="
          f"{ex['n_engine']} engine/{ex['n_scalar']} scalar, "
          f"knn groups={groups}")
    out.update(hybrid=hybrid, hybrid_rows=results, hybrid_qps=64 / dt,
               cache=ex["cache"], n_engine=ex["n_engine"],
               n_scalar=ex["n_scalar"], knn_groups=groups)

    # -------- scalar path for QBS recording (stats parity)
    t0 = time.time()
    scalar_rows = [p.execute(q, task="serving")[0] for q in hybrid[:20]]
    print(f"scalar: 20 queries in {(time.time()-t0)*1e3:.1f} ms; "
          f"QBS rows recorded (sampled 20%): {len(p.qbs)}")
    objectives = p.qbs.objectives("serving")
    print("QBS objectives:", objectives)
    out.update(scalar_rows=scalar_rows, qbs_rows=len(p.qbs),
               qbs_objectives=objectives)

    # -------- full serving stack: embed request texts -> hybrid engine
    cfg_e = get_config("mqrld-embedder-100m").reduced()
    embedder = EmbeddingServer(cfg_e, seed=0, device=dev)
    doc_toks = rng.integers(1, 200, (n, 12))
    # a real deployment embeds the corpus with the same backbone; here we
    # embed a handful of requests against the synthetic vector column
    reqs = [RetrievalRequest(tokens=doc_toks[i], attr="v", k=5,
                             predicate=Q.NR("price", 25, 75))
            for i in rng.integers(0, n, 8)]
    # embedder output dim != the synthetic column dim: the `project` hook
    # maps embeddings (host arrays, as EmbeddingServer.embed returns them)
    # onto the searched column's space (here a crude slice)
    emb_dim = p.table.vector["v"].shape[1]
    server = RetrievalServer(p, embedder, batch_size=8,
                             project=lambda e: e[:, :emb_dim])
    t0 = time.time()
    served = server.serve(reqs)
    dt = time.time() - t0
    print(f"retrieval server: {len(served)} requests in "
          f"{dt*1e3:.1f} ms; first rows:",
          served[0].rows[:5].tolist())
    # the searched vectors: every prompt has 12 tokens, so the server
    # embedded them as this one batch
    out.update(requests=reqs, served_rows=[r.rows for r in served],
               served_vectors=embedder.embed(
                   np.stack([r.tokens for r in reqs]))[:, :emb_dim],
               served_ms=dt * 1e3)

    # -------- LM serving (the generation side of the platform)
    cfg = get_config("llama3-8b").reduced()
    eng = ServeEngine(cfg, max_len=64, batch_size=4, seed=0, device=dev)
    greqs = [GenRequest(np.arange(1, 9, dtype=np.int32) * (i + 1) % 200, 8)
             for i in range(4)]
    res = eng.generate(greqs)
    print("generation:", [r.tokens.tolist() for r in res[:2]],
          f"prefill {res[0].prefill_s*1e3:.0f} ms, "
          f"decode {res[0].decode_s*1e3:.0f} ms")
    out.update(gen_tokens=[r.tokens for r in res],
               prefill_ms=res[0].prefill_s * 1e3,
               decode_ms=res[0].decode_s * 1e3)
    return out


if __name__ == "__main__":
    main()
