"""Serving engine: batched prefill + decode, and the embedder that feeds
the platform's vector columns (port of ``repro/serve/engine.py``).

Straggler/fault posture, as in the reference: requests are grouped into
same-length batches (no padding), decode runs a fixed number of steps
per batch, and the engine is stateless between batches.

``ServeEngine`` and ``EmbeddingServer`` take every family: the dense
and VLM transformers, MoE (phi3.5-moe, arctic: a prefill's expert
capacity counts per batch row, so the equal-length buckets route each
row as it would route alone), xlstm, whose prefill returns its filled
recurrent state, and the hybrid hymba and the encoder-decoder, whose
prefill returns an empty cache that ``ServeEngine`` fills by replaying
the prompt through decode (hymba's ring buffers, SSM and conv states;
enc-dec's self-attention K/V beside the cross K/V its prefill built), as
the reference's engine does. Enc-dec is fed zero frames (B,
frontend_tokens, d_model) in ``cfg.dtype``, as the reference feeds
them: with no bias anywhere its encoder's output is then exactly 0, so
its embeddings are all zero and its cross-attention adds nothing.

Port decision (serving types): a model's parameters are held in the
type the reference reads them in (matrices in ``cfg.dtype``, bf16, cast
once when the parameters are made, which is exactly the cast the
reference makes on every use; norm scales and hymba's ``a_log`` in
fp32; ``models/transformer.py``). ``device=None`` means the CUDA card
and raises without one; on the card the prefill's attention is the
hand-written flash kernel (hymba's windowed layers with their window).

``RetrievalServer`` is the retrieval half of a deployment: a dynamic
micro-batching admission queue in front of the platform's planned path.
Requests are keyed by their plan signature (``Session.signature``) and
coalesced into micro-batches of one archetype, so a warm ``LogicalPlan``
is reused; the queue is bounded (backpressure executes the oldest work),
requests past their deadline are shed before compute with an explicit
``shed`` result, and per-signature service times feed back into the QBS
table. At ``pipeline_depth`` >= 2 chunks run through
``serve.pipeline.ChunkPipeline``. On the card the embedder's forward runs
on a stream of its own (``EmbeddingServer``) and the engine dispatches on
the current stream, so a chunk's embedding does not wait for the KNN work
enqueued before it. ``attach_reopt`` hands the server an online
re-optimization controller (``core/reopt.py``), which ``poll()`` steps
between micro-batches. ``RetrievalServer(shards=S)`` serves through the
sharded device loop.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import query as Q
from repro_torch.models import build_model
from repro_torch.models.transformer import torch_dtype
from repro_torch.serve.pipeline import ChunkPipeline

# bound on RetrievalServer's signature memo: keys are predicate archetype
# strings (constants elided), so the live population is the number of
# distinct query shapes served; the cap is a leak backstop
_SIG_CACHE_MAX = 1024


@dataclass
class GenRequest:
    prompt: np.ndarray         # (S,) int32
    max_new: int = 16


@dataclass
class GenResult:
    tokens: np.ndarray
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _params(model, params, seed: int):
    if params is None:
        return model.init(seed)
    have, want = params.device, model.device
    if have.type != want.type or (want.index is not None
                                  and have.index != want.index):
        raise ValueError(f"params are on {params.device}, the engine on "
                         f"{model.device}")
    return params


def _batch(cfg: ModelConfig, tokens, device: torch.device) -> dict:
    """A model batch of ``tokens``; for enc-dec with zero frames (B,
    frontend_tokens, d_model) in ``cfg.dtype`` on ``device``, as the
    reference's engine feeds them."""
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros(
            (len(tokens), cfg.frontend_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=device)
    return batch


class ServeEngine:
    """Batched greedy generation, exact under mixed prompt lengths.

    Batching contract: ``generate`` buckets requests by PROMPT LENGTH
    and runs each bucket as a padding-free batch (chunked to
    ``batch_size``), then returns results in request order. Bucketing —
    not padding — is what keeps batched generation token-identical to
    per-request generation: ``prefill`` returns logits for the LAST
    position only and every ``KVCache`` carries one ``length``, so a
    right-padded short prompt would take its first greedy token from a
    pad position and decode against pad K/V at wrong positions, and
    left-padding would shift RoPE phases. Within a same-length batch both
    hazards vanish. Batches are sized to the requests present — no
    phantom zero rows padded up to ``batch_size``. (On the card, a
    product's reduction order may depend on the batch's row count, so
    a near tie between the top two logits can resolve differently.)

    ``params``: the model's parameters (``Model.init`` or
    ``params_from_numpy``) on ``device``; None draws them from ``seed``.
    ``prefill_s`` and ``decode_s`` are host-clock seconds of each batch's
    prefill and decode loop, each ending in a device synchronize.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 max_len: int = 512, batch_size: int = 8, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        self.params = _params(self.model, params, seed)
        self.max_len = max_len
        self.batch_size = batch_size

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        # mask padded vocab columns before argmax (first maximum wins, as
        # in jnp.argmax)
        v = self.cfg.vocab_size
        lg = logits[..., :v] if logits.shape[-1] > v else logits
        return torch.argmax(lg, dim=-1).to(torch.int32)

    def generate(self, requests: Sequence[GenRequest]) -> List[GenResult]:
        out: List[Optional[GenResult]] = [None] * len(requests)
        by_len: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.prompt), []).append(i)
        for plen in sorted(by_len):
            idx = by_len[plen]
            for j in range(0, len(idx), self.batch_size):
                sel = idx[j:j + self.batch_size]
                for i, res in zip(sel, self._run_batch(
                        [requests[i] for i in sel])):
                    out[i] = res
        return out  # type: ignore[return-value]

    @torch.no_grad()
    def _run_batch(self, reqs: Sequence[GenRequest]) -> List[GenResult]:
        plen = len(reqs[0].prompt)
        if any(len(r.prompt) != plen for r in reqs):
            raise ValueError("_run_batch requires same-length prompts "
                             "(generate buckets)")
        toks = torch.as_tensor(np.stack([np.asarray(r.prompt, np.int64)
                                         for r in reqs]),
                               device=self.device)
        max_new = max(r.max_new for r in reqs)

        t0 = time.time()
        logits, cache = self.model.prefill(
            self.params, _batch(self.cfg, toks, self.device), self.max_len)
        # the transformer's and xlstm's prefill fill the cache or state;
        # hymba's and enc-dec's return one of length 0, filled by
        # replaying the prompt through decode
        if cache.length == 0:
            for t in range(plen):
                _, cache = self.model.decode(self.params, cache,
                                             toks[:, t:t + 1])
        _sync(self.device)
        prefill_s = time.time() - t0

        t1 = time.time()
        # every row's position -1 is its true last prompt token
        cur = self._greedy(logits[:, -1])[:, None]
        gen = [cur.cpu()]
        for _ in range(max_new - 1):
            logits, cache = self.model.decode(self.params, cache, cur)
            cur = self._greedy(logits[:, -1])[:, None]
            gen.append(cur.cpu())
        decode_s = time.time() - t1
        gen_arr = torch.cat(gen, dim=1).numpy()
        return [GenResult(tokens=gen_arr[i, :reqs[i].max_new],
                          prefill_s=prefill_s, decode_s=decode_s)
                for i in range(len(reqs))]


class EmbeddingServer:
    """Embeds token batches with a pool architecture — feeds the MQRLD
    platform's vector columns. ``embed`` returns (B, d_model) fp32 numpy
    mean-pooled final hidden states.

    On a CUDA device the forward runs on the server's own stream, and the
    read-back waits for that stream alone: work other callers enqueued on
    the current stream (the retrieval engine's KNN rounds) runs beside
    it. Everything the forward makes stays on that stream; only the host
    array leaves."""

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        self.params = _params(self.model, params, seed)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the weights were made on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        if self._stream is None:
            out = self.model.embedding(self.params,
                                       _batch(self.cfg, tokens, self.device))
            return out.cpu().numpy()
        with torch.cuda.stream(self._stream):
            out = self.model.embedding(self.params,
                                       _batch(self.cfg, tokens, self.device))
            return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Retrieval serving: embedder -> hybrid engine
# ---------------------------------------------------------------------------
@dataclass
class RetrievalRequest:
    tokens: np.ndarray                   # (S,) int32 prompt tokens
    attr: str                            # vector column to search
    k: int = 10
    predicate: Optional[Q.Query] = None  # V.K-free filter tree, And-ed in
    # latency budget from arrival (submit time); None = no deadline. A
    # request whose deadline passes, or provably cannot be met even if
    # its archetype started compute now (per the QBS service times), is
    # shed before compute: its future resolves to ``shed=True``
    deadline_ms: Optional[float] = None


@dataclass
class RetrievalResult:
    rows: np.ndarray                     # result row ids (distance order)
    query: Optional[Q.Query] = None      # the MOAPI query that was run
    #                                      (None when shed before its
    #                                      embedding existed)
    shed: bool = False                   # True = deadline shed, no compute
    latency_s: float = 0.0               # end to end: arrival -> resolve


class RetrievalFuture:
    """Handle for one submitted request. ``result()`` flushes the server
    when the request has not run yet (execution is synchronous batched
    compute, not threads). A future resolves exactly once, with rows or
    with a shed result, and is immutable after that."""

    def __init__(self, server: "RetrievalServer"):
        self._server = server
        self._result: Optional[RetrievalResult] = None
        self._done = False

    def done(self) -> bool:
        return self._done

    def result(self) -> RetrievalResult:
        if not self._done:
            self._server.flush()
        if not self._done or self._result is None:
            raise RuntimeError(
                "retrieval future did not resolve: its batch failed "
                "before results were set (the request is still pending "
                "and will be retried by the next flush)")
        return self._result

    def _set(self, res: RetrievalResult):
        if self._done:       # resolved futures are immutable
            return
        self._result = res
        self._done = True


@dataclass
class _Pending:
    """One admitted request: queue entry + admission-time bookkeeping."""
    req: RetrievalRequest
    fut: RetrievalFuture
    sig: str                             # plan signature (coalescing key)
    t_submit: float                      # arrival time (server clock)
    deadline: Optional[float]            # absolute, server clock; None = inf


_E2E_KEEP = 2048  # recent end-to-end latencies kept per signature


class RetrievalServer:
    """Dynamic micro-batching retrieval server over a prepared ``MQRLD``,
    on the planned path (port of the reference's, contract for contract).

    Each micro-batch is two stages: embedding forwards bucketed by prompt
    length (padding-free, so an embedding never depends on its batch),
    then one ``Session.plan(...).execute()`` of all its queries. Requests
    wait in a bounded FIFO and are carved into micro-batches by plan
    signature (``coalesce=True``): sizes are powers of two up to
    ``batch_size``, which bounds the shape universe. ``coalesce=False``
    chunks strictly FIFO.

    Admission: at most ``max_queue`` requests (default 64 x
    ``batch_size``); a submit against a full queue first executes the
    oldest work (backpressure, nothing is dropped). A request with
    ``deadline_ms`` is shed before compute once its deadline passes, or
    predictively once its archetype's QBS p50 service time (>= 8 samples)
    says an immediate start cannot meet it. ``poll()`` / ``next_due()``
    serve open-arrival drive loops: ``max_delay_ms`` is how long a partial
    micro-batch may wait for archetype-mates, and with
    ``adaptive_window`` the window is one full-batch service time per
    signature (capped by ``max_delay_ms`` when set). Every executed
    micro-batch records its per-request service time under its signature
    (``QBSTable.record_latency``); ``stats()`` reports the counters and
    per-signature end-to-end quantiles. ``clock`` injects the time source.

    Ordering: ``serve`` returns one result per request in submission
    order and a future always resolves to its own request's result;
    coalescing changes only when a request runs, never its rows. Rows are
    distance-ordered: filtered results (And) are re-ranked by distance
    to the request's embedding. Failure: a chunk is all-or-nothing; if
    the embedder, the engine or the ranking raises, every request of the
    chunk stays pending and unresolved, and the next flush retries it.

    ``project`` maps the embedder's output (numpy) onto the searched
    column's space. ``device_loop``, ``shards`` (None: the platform's
    ``default_shards``; 0: one device) and ``precision`` pick the
    session.
    ``append(...)`` ingests rows between micro-batches. At
    ``pipeline_depth`` >= 2 chunks overlap in a ``ChunkPipeline`` (same
    rows, FIFO retirement); ``drain()`` is its quiescent barrier.

    Online re-optimization: ``attach_reopt(controller)`` hands the server
    a ``core.reopt.ReoptController``; ``poll()`` then drives one
    ``controller.step()`` after each micro-batch it runs, or at an idle
    point, and never while a chunk is in flight (in pipelined mode only
    when the pipe is empty and no shape prewarm took the tick), so an
    index swap lands between micro-batches: no chunk's ``PendingBatch``
    still waits on a CUDA event over the old generation's tiles.
    ``flush()`` never steps it. Results stay oracle-exact across a swap,
    compared by logical row identity (``platform.view().row_ids``), since
    a new generation re-permutes the physical layout. ``stats()["reopt"]``
    is the controller's ``status()``."""

    def __init__(self, platform, embedder: EmbeddingServer, *,
                 batch_size: int = 64, pad_token: int = 0,
                 project=None, device_loop: bool = True,
                 shards: Optional[int] = None,
                 precision: Optional[str] = None,
                 coalesce: bool = True,
                 max_queue: Optional[int] = None,
                 max_delay_ms: float = 0.0,
                 adaptive_window: bool = False,
                 pipeline_depth: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.platform = platform
        self.embedder = embedder
        self.batch_size = batch_size
        self.pad_token = pad_token   # kept for the API: prompts are not
        #                              padded (length buckets)
        self.project = project
        self.device_loop = device_loop
        self.shards = shards
        self.precision = precision
        self.coalesce = coalesce
        self.max_delay_ms = float(max_delay_ms)
        self.adaptive_window = bool(adaptive_window)
        self.max_queue = max_queue if max_queue is not None \
            else 64 * batch_size
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._clock = clock
        self.session = platform.session(device_loop=device_loop,
                                        shards=shards, precision=precision)
        self._pending: List[_Pending] = []   # admission FIFO
        self._sig_cache: Dict[Tuple, str] = {}
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        # depth 1 is the serial loop, with no pipeline object at all
        self._pipe = ChunkPipeline(self, self.pipeline_depth) \
            if self.pipeline_depth > 1 else None
        self._inflight_ids: set = set()      # id(_Pending) of dispatched
        self.reopt = None                    # see attach_reopt()
        self.n_submitted = 0
        self.n_served = 0
        self.n_shed = 0
        self.n_batches = 0
        self._e2e: Dict[str, List[float]] = {}

    # ------------------------------------------------------------ embedding
    def _embed_tokens(self, token_lists: Sequence[np.ndarray]) -> np.ndarray:
        """The prompt -> vector recipe, shared by query serving and
        ``append``: prompts bucketed by length into padding-free forwards,
        so an embedding depends only on its prompt (and the forward's
        batch of equal-length prompts), then ``project``."""
        lens = [len(t) for t in token_lists]
        out: List[Optional[np.ndarray]] = [None] * len(token_lists)
        for plen in sorted(set(lens)):
            idx = [i for i, n in enumerate(lens) if n == plen]
            toks = np.stack([np.asarray(token_lists[i], np.int32)
                             for i in idx])
            emb = self.embedder.embed(toks)
            if self.project is not None:
                emb = np.asarray(self.project(emb))
            for j, i in enumerate(idx):
                out[i] = np.asarray(emb[j])
        return np.stack(out)  # type: ignore[arg-type]

    def _queries(self, reqs: Sequence[RetrievalRequest],
                 emb: np.ndarray) -> List[Q.Query]:
        out = []
        for r, e in zip(reqs, emb):
            vk = Q.VK.of(r.attr, e, r.k)
            out.append(vk if r.predicate is None
                       else Q.And.of(r.predicate, vk))
        return out

    def _ranked(self, req: RetrievalRequest, emb: np.ndarray,
                rows: np.ndarray) -> np.ndarray:
        if req.predicate is None or len(rows) == 0:
            return rows  # a top-level V.K is distance-ordered already
        # view(): row ids may point into the un-folded delta region
        col = self.platform.view().vector[req.attr][rows]
        d2 = ((col - emb[None, :]) ** 2).sum(1)
        return rows[np.argsort(d2, kind="stable")]

    def signature(self, request: RetrievalRequest) -> str:
        """The plan signature this request coalesces under, computed
        without its embedding (signatures elide vector constants). Cached
        per (attr, k, predicate signature), FIFO-bounded."""
        pred_sig = None if request.predicate is None \
            else Q.signature(Q.normalize(request.predicate))
        key = (request.attr, int(request.k), pred_sig)
        sig = self._sig_cache.get(key)
        if sig is None:
            vk = Q.VK.of(request.attr, (), int(request.k))
            q = vk if request.predicate is None \
                else Q.And.of(request.predicate, vk)
            sig = self.session.signature(q)
            if len(self._sig_cache) >= _SIG_CACHE_MAX:
                self._sig_cache.pop(next(iter(self._sig_cache)))
            self._sig_cache[key] = sig
        return sig

    # ------------------------------------------------------------- writes
    def append(self, *, numeric=None, vectors=None, tokens=None,
               attr: Optional[str] = None,
               raw_uri: Optional[Sequence[str]] = None,
               fold: Optional[bool] = None) -> int:
        """Ingest new MMOs between micro-batches. ``vectors`` gives
        embedding columns directly; ``tokens`` (int32 prompt arrays) are
        embedded by the query recipe into the ``attr`` column. Returns the
        live delta rows; ``fold`` goes to ``MQRLD.append``. In-flight
        chunks are drained first, so they resolve against the state they
        were planned on; requests still queued see the rows at their flush.
        A failure (embedding, validation) changes nothing."""
        self.drain()
        vectors = dict(vectors or {})
        if tokens is not None:
            if attr is None:
                raise ValueError("append(tokens=...) needs attr=")
            vectors[attr] = self._embed_tokens(tokens)
        return self.platform.append(numeric=numeric, vector=vectors,
                                    raw_uri=raw_uri, fold=fold)

    # ------------------------------------------------------------- async
    @property
    def queue_depth(self) -> int:
        return len(self._pending) + len(self._inflight_ids)

    @property
    def inflight_chunks(self) -> int:
        """Chunks dispatched in the pipeline (0 in serial mode); their
        requests count in ``queue_depth`` until they retire."""
        return 0 if self._pipe is None else self._pipe.inflight

    def _pickable(self) -> List[_Pending]:
        """Pending entries not in a dispatched chunk (dispatched entries
        leave ``_pending`` and come back only if their chunk fails)."""
        return self._pending

    def _mark_inflight(self, chunk: Sequence[_Pending]) -> None:
        ids = set(map(id, chunk))
        self._inflight_ids |= ids
        self._pending = [p for p in self._pending if id(p) not in ids]

    def _unmark_inflight(self, chunk: Sequence[_Pending], *,
                         requeue: bool = False) -> None:
        """Drop a chunk from the in-flight set; ``requeue=True`` (it
        failed) puts its entries back at the front of the queue, oldest
        work first."""
        self._inflight_ids.difference_update(map(id, chunk))
        if requeue:
            self._pending[:0] = chunk

    def drain(self) -> int:
        """Pipeline barrier: retire every in-flight chunk without
        dispatching new work (no-op in serial mode). Returns requests
        served."""
        if self._pipe is None:
            return 0
        return self._pipe.drain()

    def submit(self, request: RetrievalRequest, *,
               now: Optional[float] = None) -> RetrievalFuture:
        """Admit one request; returns its future. ``now`` overrides the
        arrival time (trace replay). A micro-batch runs as soon as some
        signature has ``batch_size`` requests queued (FIFO mode: any
        ``batch_size``); a full queue first executes the oldest work."""
        t = self._clock() if now is None else now
        self._shed_expired(t)
        while self.queue_depth >= self.max_queue:
            self.flush_one()          # backpressure: execute, never drop
        fut = RetrievalFuture(self)
        dl = None if request.deadline_ms is None \
            else t + float(request.deadline_ms) / 1e3
        self._pending.append(_Pending(
            req=request, fut=fut, sig=self.signature(request),
            t_submit=t, deadline=dl))
        self.n_submitted += 1
        if self.coalesce:
            counts: Dict[str, int] = {}
            for p in self._pickable():
                counts[p.sig] = counts.get(p.sig, 0) + 1
            if any(c >= self.batch_size for c in counts.values()):
                self._autoflush()
        elif len(self._pickable()) >= self.batch_size:
            self._autoflush()
        return fut

    def _autoflush(self) -> None:
        """A full micro-batch exists at submit time: serial mode runs it,
        pipelined mode only dispatches it (retiring first when the pipe is
        full)."""
        if self._pipe is None:
            self.flush_one()
            return
        if self._pipe.inflight >= self._pipe.depth:
            self._pipe.retire()
        self._pipe.dispatch(self._next_chunk())

    def result(self, future: RetrievalFuture) -> RetrievalResult:
        return future.result()

    def flush(self):
        """Run every pending request, one micro-batch at a time; a chunk
        leaves the queue only once it executed. Pipelined mode fills free
        slots and retires FIFO until queue and pipe are empty."""
        if self._pipe is not None:
            while True:
                self._shed_expired(self._clock())
                if self._pipe.inflight >= self._pipe.depth:
                    self._pipe.retire()
                elif self._pickable():
                    self._pipe.dispatch(self._next_chunk())
                elif self._pipe.inflight:
                    self._pipe.retire()
                else:
                    return
        while self._pending:
            self.flush_one()

    def flush_one(self) -> int:
        """Shed expired work, then execute one micro-batch regardless of
        the window; returns requests served. Pipelined mode dispatches one
        chunk when a slot is free, then retires the oldest."""
        self._shed_expired(self._clock())
        if self._pipe is not None:
            if self._pickable() and \
                    self._pipe.inflight < self._pipe.depth:
                self._pipe.dispatch(self._next_chunk())
            return self._pipe.retire()
        if not self._pending:
            return 0
        chunk = self._next_chunk()
        self._run_chunk(chunk)
        return len(chunk)

    def poll(self) -> int:
        """Window-respecting ``flush_one`` for open-arrival loops: runs a
        micro-batch only if one is due (a full group, a window waited out,
        or a deadline inside the window). Returns requests served (0:
        come back at ``next_due()``). With a controller attached, one
        ``step()`` follows the micro-batch, or takes the idle point.
        Pipelined mode dispatches every due chunk a free slot takes,
        retires the oldest, and spends idle ticks on shape prewarming,
        else on the controller."""
        now = self._clock()
        self._shed_expired(now)
        if self._pipe is not None:
            return self._poll_pipelined(now)
        if not self._pending or not self._due(now):
            self._reopt_step()
            return 0
        chunk = self._next_chunk()
        self._run_chunk(chunk)
        self._reopt_step()
        return len(chunk)

    def _poll_pipelined(self, now: float) -> int:
        """One pipelined step: the controller steps only once the pipe
        is empty (a swap must find no chunk in flight) and only on a tick
        that no shape prewarm used."""
        pipe = self._pipe
        while (pipe.inflight < pipe.depth and self._pickable()
               and self._due(now)):
            pipe.dispatch(self._next_chunk())
        if pipe.inflight:
            served = pipe.retire()
            if pipe.inflight == 0:
                self._reopt_step()
            return served
        if not pipe.prewarm_step():     # idle: warm a partial shape
            self._reopt_step()
        return 0

    def _window_s(self, sig: str) -> float:
        """Batching window (s) of a signature: ``max_delay_ms``, or with
        ``adaptive_window`` one full-batch service time (QBS p50 x
        ``batch_size``, >= 8 samples) capped by ``max_delay_ms`` when
        set."""
        base = self.max_delay_ms / 1e3
        if not self.adaptive_window:
            return base
        lq = self.platform.qbs.latency_quantiles(sig)
        if lq is None or lq["n"] < 8:
            return base
        w = float(lq["p50"]) * self.batch_size
        return min(base, w) if base > 0 else w

    def next_due(self) -> Optional[float]:
        """Earliest clock time at which a pending entry's window (or its
        deadline) runs out; None when nothing is pending."""
        avail = self._pickable()
        if not avail:
            return None
        win: Dict[str, float] = {}
        due = []
        for p in avail:
            if p.sig not in win:
                win[p.sig] = self._window_s(p.sig)
            t = p.t_submit + win[p.sig]
            due.append(t if p.deadline is None else min(t, p.deadline))
        return min(due)

    def _due(self, now: float) -> bool:
        avail = self._pickable()
        if len(avail) >= self.batch_size:
            return True
        if self.coalesce:
            counts: Dict[str, int] = {}
            for p in avail:
                counts[p.sig] = counts.get(p.sig, 0) + 1
                if counts[p.sig] >= self.batch_size:
                    return True
        win: Dict[str, float] = {}
        for p in avail:
            if p.sig not in win:
                win[p.sig] = self._window_s(p.sig)
            w = win[p.sig]
            if w <= 0 or now - p.t_submit >= w:
                return True
            if p.deadline is not None and p.deadline <= now + w:
                return True
        return False

    # ------------------------------------------------- re-optimization
    def attach_reopt(self, controller) -> None:
        """Attach a ``core.reopt.ReoptController``, which ``poll()`` then
        steps. A controller built without a session takes this server's,
        so its plan prewarming lands in the cache serving reads."""
        if controller.session is None:
            controller.session = self.session
        self.reopt = controller

    def _reopt_step(self) -> Optional[str]:
        """One unit of the controller's cooperative work (None without
        one). Called only between micro-batches and at idle points, so a
        swap inside ``step()`` is never seen by a half-executed batch."""
        if self.reopt is None:
            return None
        if self._pipe is not None and self._pipe.inflight:
            raise RuntimeError("a re-optimization step with a chunk in "
                               "flight")
        return self.reopt.step()

    # ------------------------------------------------------ admission ctrl
    def _service_estimate(self, sig: str) -> float:
        """Expected per-request service time of an archetype (QBS p50;
        0.0 below 8 samples, so cold archetypes are never shed
        predictively)."""
        lq = self.platform.qbs.latency_quantiles(sig)
        if lq is None or lq["n"] < 8:
            return 0.0
        return float(lq["p50"])

    def _shed_expired(self, now: float):
        """Resolve with ``shed=True`` every pending request whose deadline
        passed or cannot be met starting now. In-flight entries are not in
        ``_pending`` and are never shed: their compute is enqueued."""
        keep: List[_Pending] = []
        est: Dict[str, float] = {}
        for p in self._pending:
            if p.deadline is None:
                keep.append(p)
                continue
            if p.sig not in est:
                est[p.sig] = self._service_estimate(p.sig)
            if p.deadline <= now + est[p.sig]:
                p.fut._set(RetrievalResult(
                    rows=np.empty(0, np.int64), query=None, shed=True,
                    latency_s=max(0.0, now - p.t_submit)))
                self.n_shed += 1
            else:
                keep.append(p)
        self._pending = keep

    def _next_chunk(self) -> List[_Pending]:
        """The next micro-batch (queue non-empty): the full signature
        group with the oldest head, else the oldest request's group; a
        partial group rounds down to a power of two. FIFO mode: the first
        ``batch_size`` entries. Entries are selected, not removed."""
        avail = self._pickable()
        if not self.coalesce:
            return avail[:self.batch_size]
        groups: Dict[str, List[_Pending]] = {}
        for p in avail:
            groups.setdefault(p.sig, []).append(p)
        full = [g for g in groups.values() if len(g) >= self.batch_size]
        if full:
            grp = min(full, key=lambda g: g[0].t_submit)
        else:
            grp = groups[avail[0].sig]
        take = self.batch_size if len(grp) >= self.batch_size \
            else 2 ** int(math.log2(len(grp)))
        return grp[:take]

    # ---------------------------------------------------------- execution
    def _run_chunk(self, chunk: Sequence[_Pending]):
        """One micro-batch, all-or-nothing: every result is computed and
        ranked before any future resolves or entry leaves the queue."""
        reqs = [p.req for p in chunk]
        t0 = self._clock()
        emb = self._embed_tokens([r.tokens for r in reqs])
        queries = self._queries(reqs, emb)
        rows, _ = self.session.plan(
            queries, device_loop=self.device_loop).execute()
        ranked = [self._ranked(req, e, r)
                  for req, e, r in zip(reqs, emb, rows)]
        self._finish_chunk(chunk, queries, ranked, t0)

    def _finish_chunk(self, chunk: Sequence[_Pending], queries,
                      ranked, t0: float) -> None:
        """The one mutation point of a computed chunk (serial loop and
        pipeline alike): resolve futures, dequeue, record the service time
        and end-to-end latency. Nothing here raises."""
        t1 = self._clock()
        per_req_s = (t1 - t0) / max(1, len(chunk))
        sig_counts: Dict[str, int] = {}
        for p, rk, q in zip(chunk, ranked, queries):
            p.fut._set(RetrievalResult(rows=rk, query=q,
                                       latency_s=max(0.0,
                                                     t1 - p.t_submit)))
            sig_counts[p.sig] = sig_counts.get(p.sig, 0) + 1
            e2e = self._e2e.setdefault(p.sig, [])
            e2e.append(max(0.0, t1 - p.t_submit))
            if len(e2e) > _E2E_KEEP:
                del e2e[:len(e2e) - _E2E_KEEP]
        for sig, n in sig_counts.items():
            self.platform.qbs.record_latency(sig, per_req_s, n=n)
        done = {id(p) for p in chunk}
        self._pending = [p for p in self._pending if id(p) not in done]
        self.n_served += len(chunk)
        self.n_batches += 1

    # ------------------------------------------------------------- sync
    def serve(self, requests: Sequence[RetrievalRequest]
              ) -> List[RetrievalResult]:
        futures = [self.submit(r) for r in requests]
        self.flush()
        return [f.result() for f in futures]

    def stats(self) -> dict:
        """Serving counters and per-signature end-to-end latency
        quantiles (s); service-time quantiles live in the QBS table.
        ``generation`` / ``build_id`` name the serving index; ``reopt`` is
        the attached controller's ``status()`` (None without one)."""
        by_sig = {}
        for sig, ls in self._e2e.items():
            a = np.asarray(ls, np.float64)
            by_sig[sig] = {"p50_s": float(np.quantile(a, 0.5)),
                           "p99_s": float(np.quantile(a, 0.99)),
                           "n": len(ls)}
        return {"submitted": self.n_submitted, "served": self.n_served,
                "shed": self.n_shed, "batches": self.n_batches,
                "queue_depth": self.queue_depth,
                "pipeline_depth": self.pipeline_depth,
                "inflight_chunks": self.inflight_chunks,
                "generation": self.platform.generation,
                "build_id": self.platform.build_id,
                "reopt": None if self.reopt is None
                else self.reopt.status(),
                "by_signature": by_sig}
