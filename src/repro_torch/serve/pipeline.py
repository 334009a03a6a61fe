"""Chunk-level pipelined executor for ``RetrievalServer`` — port of
``repro/serve/pipeline.py``.

A bounded three-stage software pipeline over signature-coalesced
micro-batch chunks, on one Python thread:

  1. **stage/embed** (host, and on the card the embedder's own stream):
     tokens -> embeddings -> query trees for the newest chunk;
  2. **dispatch** (device): ``Session.plan(...).execute_async()``
     enqueues the chunk's KNN first rounds on the current stream, starts
     their results' copies into pinned host memory behind an event, and
     returns (``core.planner.PendingExecution``);
  3. **epilogue** (host): ``materialize()`` waits on the chunk's events,
     runs the straggler rounds and the finishing walk, ranks rows,
     resolves futures and records QBS latency, convergence and workload.

With ``depth`` chunks in flight, chunk *i*'s epilogue and chunk *i+2*'s
embedding run on the host while the card executes chunk *i+1*'s
enqueued work; CUDA's asynchronous launches give the overlap, and one
stream runs the engine's work in dispatch order, so retiring an older
chunk never waits on a newer chunk's work. Predicate masks are host
numpy, as in the reference, so a chunk with predicates syncs before its
dispatch.

Fence contract: after its dispatch a chunk's only device syncs are in
its ``materialize()``. ``depth=1`` builds no pipeline: the server keeps
its serial loop.

Ordering and failure (as the serial loop): chunks retire strictly FIFO,
so each future resolves once, in its own chunk's epilogue; a chunk is
all-or-nothing (a dispatch or epilogue failure leaves its requests
pending and retryable and propagates; other chunks are untouched);
``drain()`` retires every in-flight chunk (and settles a prewarm)
without dispatching, the quiescent boundary ``append`` and an index
swap need (the server steps its re-optimization controller only with
the pipe empty).

Shape prewarming: the first time a signature dispatches a full chunk,
its power-of-two partial sizes are queued; idle polls run one at a time
through the free slot (``prewarm_step``, ``record=False``, results
discarded), so later partial chunks find their plan skeletons and
compiled kernels warm.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Sequence, Set, Tuple


class _InflightChunk:
    """One dispatched micro-batch: its queue entries, staged inputs and
    the deferred epilogue."""

    __slots__ = ("chunk", "reqs", "emb", "queries", "pending", "t0")

    def __init__(self, chunk, reqs, emb, queries, pending, t0):
        self.chunk = chunk
        self.reqs = reqs
        self.emb = emb
        self.queries = queries
        self.pending = pending
        self.t0 = t0


class ChunkPipeline:
    """A server's in-flight chunks (a FIFO bounded by ``depth``) and its
    shape-prewarm queue; driven from the server's
    ``poll``/``flush``/``submit`` on one thread."""

    def __init__(self, server, depth: int):
        if depth < 2:
            raise ValueError("ChunkPipeline needs depth >= 2 "
                             "(depth 1 is the server's serial loop)")
        self.server = server
        self.depth = int(depth)
        self._inflight: Deque[_InflightChunk] = deque()
        # signatures whose full shape was seen, the (sig, template query,
        # size) prewarm queue, and the prewarm execution in flight
        self._warm_seen: Set[str] = set()
        self._warm_queue: Deque[Tuple[str, object, int]] = deque()
        self._warm_pending = None

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------ stages
    def dispatch(self, chunk: Sequence) -> None:
        """Stages 1 and 2 for one chunk: embed and build its queries, then
        enqueue its planned execution and append it to the FIFO. On a
        raise nothing was appended, so its entries stay pending."""
        srv = self.server
        reqs = [p.req for p in chunk]
        t0 = srv._clock()
        emb = srv._embed_tokens([r.tokens for r in reqs])
        queries = srv._queries(reqs, emb)
        pending = srv.session.plan(
            queries, device_loop=srv.device_loop).execute_async()
        self._inflight.append(_InflightChunk(
            list(chunk), reqs, emb, queries, pending, t0))
        srv._mark_inflight(chunk)
        self._note_shape(chunk, queries)

    def retire(self) -> int:
        """Stage 3 for the oldest in-flight chunk: materialize, rank, then
        the server's shared epilogue (``_finish_chunk``). Returns requests
        served (0: nothing in flight). A raise before the mutation point
        puts the chunk's entries back in the queue, unresolved."""
        if not self._inflight:
            return 0
        srv = self.server
        ent = self._inflight[0]
        try:
            rows, _ = ent.pending.materialize()
            ranked = [srv._ranked(req, e, r) for req, e, r in
                      zip(ent.reqs, ent.emb, rows)]
        except BaseException:
            self._inflight.popleft()
            srv._unmark_inflight(ent.chunk, requeue=True)
            raise
        self._inflight.popleft()
        srv._unmark_inflight(ent.chunk)
        srv._finish_chunk(ent.chunk, ent.queries, ranked, ent.t0)
        return len(ent.chunk)

    def drain(self) -> int:
        """Retire every in-flight chunk in FIFO order and settle a prewarm
        in flight, dispatching nothing. Returns requests served."""
        n = 0
        while self._inflight:
            n += self.retire()
        if self._warm_pending is not None:
            pend, self._warm_pending = self._warm_pending, None
            pend.materialize()
        return n

    # ---------------------------------------------------------- prewarm
    def _note_shape(self, chunk: Sequence, queries: List) -> None:
        """A signature's first full chunk queues its power-of-two partial
        sizes, largest first."""
        srv = self.server
        sig = chunk[0].sig
        if len(chunk) < srv.batch_size or sig in self._warm_seen:
            return
        self._warm_seen.add(sig)
        size = srv.batch_size // 2
        while size >= 1:
            self._warm_queue.append((sig, queries[0], size))
            size //= 2

    def prewarm_step(self) -> bool:
        """One idle tick of prewarming: materialize the prewarm in flight,
        else dispatch the next queued size (``record=False``: nothing
        reaches the QBS rings or the latency stats). Returns True when it
        did work."""
        if self._warm_pending is not None:
            pend, self._warm_pending = self._warm_pending, None
            pend.materialize()
            return True
        if not self._warm_queue:
            return False
        srv = self.server
        _, query, size = self._warm_queue.popleft()
        plan = srv.session.plan([query] * size,
                                device_loop=srv.device_loop)
        self._warm_pending = plan.execute_async(record=False)
        return True
