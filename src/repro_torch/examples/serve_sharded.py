"""Mesh-enabled serving: the T-sharded hybrid-query path.

The tile-major bucket layout shards along T over S placement slots —
strided placement so each shard holds an even 1/S sample of the
tree-ordered tiles — and every KNN beam round runs per shard with a
k-way merge of the per-shard top-k heaps; V.R routes its triangle-bound
planning and union GEMM per shard the same way. Every shard count
returns an exact top-k — row-identical to the single-device path on
tie-free data (the single-device path stays the exactness oracle) — so
the knob is pure throughput.

On one card every shard lives on that card (``sharding.tile_mesh``), so
S = 1, 2 and 8 all run and none is skipped; the shards' rounds are
stacked into one kernel launch over S times the rows.

    PYTHONPATH=src python -m repro_torch.examples.serve_sharded \\
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.serve.engine import RetrievalRequest, RetrievalServer


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
    p = MQRLD(table, seed=0, device=dev)
    p.prepare(min_leaf=64, max_leaf=1024)
    print(f"platform ready: {n} MMOs, device={dev}")

    # one query batch, served at several shard topologies
    qs = [Q.And.of(Q.NR("price", 20, 80), Q.VK.of("v", vec[i], 10))
          for i in rng.integers(0, n, 32)]
    baseline = None
    runs = {}
    for shards in (None, 1, 2, 8):
        sess = p.session(shards=shards)
        plan = sess.plan(qs)
        ex = plan.explain()
        plan.execute()                      # warm the shapes
        t0 = time.time()
        rows, stats = sess.plan(qs).execute()
        dt = time.time() - t0
        if baseline is None:
            baseline = rows
        agree = all(set(a.tolist()) == set(b.tolist())
                    for a, b in zip(rows, baseline))
        print(f"shards={shards or 'off'}: {len(qs) / dt:.0f} qps, "
              f"plan shards={ex['shards']}, rounds={stats.knn_rounds}, "
              f"identical={agree}")
        runs[shards or "off"] = dict(rows=rows, qps=len(qs) / dt,
                                     plan_shards=ex["shards"],
                                     rounds=stats.knn_rounds,
                                     identical=agree)

    # the shard topology is a platform default too: servers and
    # persisted snapshots pick it up without threading the knob around
    p.default_shards = 2

    class TableEmbedder:
        """Stub (prompt token -> stored vector + eps), host arrays out."""

        def embed(self, toks):
            return vec[np.asarray(toks)[:, 0] % n] + 0.01

    srv = RetrievalServer(p, TableEmbedder(), batch_size=8)
    reqs = [RetrievalRequest(
        tokens=np.asarray([i, 1], np.int32), attr="v", k=5,
        predicate=Q.NR("price", 10, 90)) for i in (3, 77, 1912)]
    futs = [srv.submit(r) for r in reqs]
    served = []
    for f in futs:
        res = f.result()
        served.append(res.rows)
        print(f"served {len(res.rows)} rows (sharded mesh, "
              f"exact): {res.rows[:5].tolist()}")
    return dict(table=table, queries=qs, runs=runs, row_ids=p.view().row_ids,
                server_shards=srv.session.shards, requests=reqs,
                served_rows=served, served_vectors=vec[[3, 77, 1912]] + 0.01)


if __name__ == "__main__":
    main()
