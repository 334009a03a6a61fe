"""Pipelined serving: chunk-stage overlap in the RetrievalServer.

``pipeline_depth=1`` (the default) is the serial loop: each micro-batch
is embedded, executed, ranked, and resolved before the next one starts.
``pipeline_depth>=2`` runs chunks through a bounded three-stage software
pipeline (repro_torch.serve.pipeline.ChunkPipeline):

    host  embed/stage  | chunk i+2
    device compute     | chunk i+1   (kernels enqueued on the card's stream)
    host  rank/record  | chunk i

The host's epilogue for an older chunk and the staging of a newer one
run WHILE the device executes the chunk in between — CUDA's asynchronous
launches provide the concurrency with no extra threads. Every serving
contract is preserved (in-order per-request resolution, all-or-nothing
chunk failure, deadline shedding, quiescent append/swap boundaries),
and results stay byte-identical to the serial loop — the knob is pure
sustained throughput under load.

This script replays the SAME overloaded open-arrival trace at depth 1
and depth 3 and prints the sustained QPS of each, then demonstrates the
drain barrier around a live ``append``.

    PYTHONPATH=src python -m repro_torch.examples.serve_pipelined \\
        [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.serve.engine import RetrievalRequest, RetrievalServer


ROWS = 20000            # rows of the catalog

class _TableEmbedder:
    """Deterministic stub (prompt token -> stored vector + eps): the
    example measures the serving loop, not an embedding backbone. It
    returns host arrays, as ``EmbeddingServer.embed`` does."""

    def __init__(self, table):
        self.table = table

    def embed(self, tokens):
        rows = np.asarray(tokens)[:, 0] % self.table.n_rows
        return self.table.vector["v"][rows] + 0.01


def _requests(n_req, n_rows, rng, ks=(10, 25, 5)):
    return [RetrievalRequest(
        tokens=np.asarray([int(rng.integers(0, n_rows)), 0], np.int32),
        attr="v", k=ks[i % len(ks)]) for i in range(n_req)]


def _replay(server, reqs, arrivals):
    """Open-arrival replay (wall clock): submit on arrival, poll the
    server, and drain at the end. Returns sustained QPS."""
    t_start = time.monotonic()
    offset = arrivals[0] - t_start - 1e-3
    futs, i = [], 0
    while i < len(reqs) or server.queue_depth:
        now = time.monotonic() + offset
        while i < len(reqs) and arrivals[i] <= now:
            futs.append(server.submit(reqs[i], now=arrivals[i]))
            i += 1
        server.poll()
    server.drain()
    span = (time.monotonic() + offset) - arrivals[0]
    assert all(f.done() for f in futs)
    return len(reqs) / max(span, 1e-9), [f.result() for f in futs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d = ROWS, 32
    centers = rng.normal(size=(12, d)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 12, n)]
           + rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    table = (MMOTable("catalog").add_vector("v", vec)
             .add_numeric("price", price))
    p = MQRLD(table, seed=0, device=dev)
    rep = p.prepare(min_leaf=64, max_leaf=1024)
    print(f"platform ready: {n} MMOs, {rep.n_leaves} buckets")

    n_req, batch = 256, 32
    # one overloaded Poisson trace, replayed verbatim at BOTH depths:
    # the queue never empties, so stage overlap — not arrival gaps —
    # decides throughput
    reqs = _requests(n_req, n, np.random.default_rng(2))
    arr_rel = np.cumsum(np.random.default_rng(3)
                        .exponential(1.0 / 2000.0, n_req))
    servers = {depth: RetrievalServer(p, _TableEmbedder(p.table),
                                      batch_size=batch,
                                      pipeline_depth=depth)
               for depth in (1, 3)}
    # warm every chunk shape this trace can touch: the carver quantizes
    # partial chunks to powers of two per signature, so |signatures| x
    # log2(batch)+1 shapes cover every chunk either depth will dispatch
    # (the engine's caches are the platform's — one sweep serves both
    # servers)
    wr = np.random.default_rng(4)
    for k in (10, 25, 5):
        s = 1
        while s <= batch:
            servers[1].serve(_requests(s, n, wr, ks=(k,)))
            s *= 2
    # interleaved replays, best-of per depth: process-wide state (the
    # engines' caches, QBS beam widths) keeps warming across replays, so
    # a back-to-back comparison would credit whichever depth ran last.
    # Rep 0 is a throwaway that finishes that warmup.
    qps, rows = {1: 0.0, 3: 0.0}, {}
    for rep in range(3):
        for depth, srv in servers.items():
            q, res = _replay(srv, list(reqs),
                             time.monotonic() + 0.01 + arr_rel)
            if rep == 0:
                continue
            qps[depth] = max(qps[depth], q)
            rows[depth] = [r.rows for r in res]
    for depth in (1, 3):
        print(f"depth {depth}: sustained {qps[depth]:.0f} QPS")
    same = all(np.array_equal(a, b)
               for a, b in zip(rows[1], rows[3]))
    print(f"rows identical to serial: {same}  "
          f"overlap gain {qps[3] / qps[1]:.2f}x "
          f"(the rows are the serial loop's byte for byte; the gain is "
          f"the device time of a chunk the pipeline hides behind the "
          f"host's stages, so it grows with device-bound workloads)")
    out = dict(table=table, requests=reqs, qps=qps, rows=rows, identical=same,
               gain=qps[3] / qps[1], row_ids=p.view().row_ids,
               vectors=p.table.vector["v"])

    # drain barrier: append lands between micro-batches even with
    # chunks in flight — dispatched work resolves against pre-append
    # state, later requests see the new rows
    srv = RetrievalServer(p, _TableEmbedder(p.table), batch_size=batch,
                          pipeline_depth=3)
    pre = [srv.submit(r)                 # one k => one full signature
           for r in _requests(batch, n, rng, ks=(10,))]   # group forms
    inflight = srv.inflight_chunks
    print(f"in flight before append: {inflight} chunk(s)")
    srv.append(vectors={"v": vec[:5] + 0.001},
               numeric={"price": price[:5]}, fold=False)
    resolved = sum(f.done() for f in pre)
    print(f"after append: {srv.inflight_chunks} in flight, "
          f"{resolved}/{len(pre)} pre-append futures "
          f"resolved by the drain")
    out.update(inflight_before=inflight,
               inflight_after=srv.inflight_chunks, resolved=resolved,
               pre_append=len(pre), n_delta=p.n_delta)
    return out


if __name__ == "__main__":
    main()
