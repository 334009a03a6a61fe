"""Batched hybrid-query engine on one device — port of the single-device
part of ``repro/core/engine.py``.

The engine holds the cluster-tree leaves as padded bucket tiles plus
per-tile ball/box metadata on ``device``, plans a batch of heterogeneous
query trees into a few vectorized stages, and executes them:

  1. **Predicate masks** — exact (g, n) masks per (type, attr) group: a
     fused compare for N.E/N.R, and for V.R the tile triangle bound
     (``_vr_leaf_plan``), then either the union GEMM over surviving tiles
     (``_vr_union_eval``) or the dense pairwise pass
     (``_vr_dense_masks``), with rows near the boundary re-checked on
     the host by the exact formula.
  2. **Masked KNN** — every V.K node becomes a job; jobs are grouped per
     attribute and scanned in beam rounds through the fused
     ``topk_l2_masked`` kernel over each query's best-lower-bound tiles.

Two beam loops return identical rows: the host doubling loop
(``batched_knn``, the exactness oracle) and the device loop
(``batched_knn_device``: one fused first round, then a straggler loop
that reads the (G,) active mask once per round where the reference runs
a ``lax.while_loop``; same static round budget, same retirement rounds,
same stats).

Mixed-precision tile scan (``precision``: "fp32" | "bf16" | "int8"):
both beam loops can scan int8 or bf16 tile planes (``utils.quant
.plan_tiles``, built once per layout) through the ``quant_lb2`` kernel,
widen the result into a lower bound on the true distance, refute
candidates whose bound strictly exceeds the running kth, and rescore the
rest in fp32 (``ops.topk_l2_masked_mp``). Rows are the fp32 path's;
``EngineStats.mp_scanned``/``mp_rescued`` count the work. The V.R path
stays fp32, as in the reference.

Persisted planes: ``quant_cache`` (a snapshot's ``quant.npz`` with its
``precision``) hands the base layouts' planes to the engine, which takes
them as they are when their shape matches the tiles and quantizes
otherwise; ``snapshot_planes`` returns them under the reference's keys.

Async split (the serving pipeline's): ``execute_batch_async`` stages the
predicate masks (host numpy, so that stage syncs, as in the reference),
then dispatches each KNN group: the queries and masks go up through
pinned memory without a host sync, the prologue and first round are
enqueued on the current stream, the results the straggler loop reads
start for pinned host buffers, and an event is recorded behind them.
``PendingBatch.materialize()`` waits on each event and runs the rest:
the rows and stats are ``execute_batch``'s, which is the same dispatch
finished at once.

Ingest: ``sync_delta`` splices the platform's ``DeltaRegion`` into the
device state. Delta rows get their own tiles in both layouts, with exact
per-tile balls and boxes and their own int8/bf16 planes, appended after
the base tiles, so both beam loops, the V.R planner and the predicate
masks see one tile universe over base plus delta. The delta's unused
capacity rows are NaN, which fails every predicate (the distance
kernels keep NaN through their clamp); their tile slots carry row id -1
and zeroed data, and empty delta tiles radius -inf. Only the delta is
uploaded; the union is a ``torch.cat`` onto the resident base, rebuilt
once per write epoch.

Certified exact re-rank (a port decision the reference does not make):
the fused kernels compute squared distances by the quadratic expansion
|q|^2 + |p|^2 - 2 q.p in fp32, whose error is at most
E = 4 d u (|q|^2 + max|p|^2) with u = 2^-24. At d=512 and |q|^2 ~ 2e4
that bound (~5) exceeds the gaps between consecutive neighbours' squared
distances, so expansion order and the oracle's exact order may disagree.
The scan therefore keeps ``_RERANK_EXTRA`` more candidates than the
stopping rank (which stays k, so rounds, buckets and rows scanned are
unchanged), and each job's candidates are re-ranked on the host by the
oracle's own formula ``sum((x - q)**2)``, exactly equal distances by row
id as the oracle orders them. ``_rerank_certified`` then
proves the result: the k-th exact distance among the candidates must lie
strictly below a lower bound, net of every fp32 error, on each row left
out (rows the kernel ranked past the candidates, rows it may have skipped
by their tile bound, rows of tiles never scanned). The jobs that fail the
proof take ``widen_exact``: one pairwise pass of their queries over the whole
column keeps every row that could still rank within k, and those rows
are re-ranked exactly (``EngineStats.knn_exact_fallbacks`` counts the
jobs). Where the expansion order is already exact the certified rows
are the reference's. On the mixed-precision scan the rows left out also
include the candidates the rescue refuted against an fp32 expansion kth;
the proof holds the k-th exact distance below the least of their bounds
too.
"""
from __future__ import annotations

import copy
import math
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import cost as costm
from repro_torch.core import query as Q
from repro_torch.core.lake import _next_pow2
from repro_torch.kernels import ops
from repro_torch.kernels.ref import stable_topk
from repro_torch.sharding.partitioning import (TileMesh, shard_put,
                                               strided_tile_layout,
                                               tile_mesh)
from repro_torch.utils import quant

# candidates kept past the stopping rank for the re-rank: a margin for
# speed only, since a job whose margin is too thin to certify takes
# ``widen_exact`` instead
_RERANK_EXTRA = 8
_INF = float("inf")
_U32 = 2.0 ** -24   # unit roundoff of fp32
# bytes one beam round may gather as its (G, W, cap, d) tile slab (fp32
# rows, or the codes of a reduced-precision scan): a QBS seed can ask for
# rounds over thousands of tiles (queries far from every cluster converge
# at nearly the whole table), and rows never depend on round widths, so a
# round's width is capped to fit
_ROUND_BYTES = 4 << 30


def _round_tiles(g: int, data_tiles, planes=None) -> int:
    """The most tiles one round of ``g`` queries may scan within
    ``_ROUND_BYTES``: the (T, cap, d) slab it gathers is ``data_tiles``,
    or the planes' codes on a reduced-precision scan."""
    t = data_tiles if planes is None else planes[0]
    _, cap, dim = t.shape
    return max(1, _ROUND_BYTES // max(1, g * cap * dim * t.element_size()))


# ---------------------------------------------------------------------------
# Device leaf state
# ---------------------------------------------------------------------------
@dataclass
class LeafGeometry:
    """Struct-of-arrays for one vector space over the shared bucket
    layout: per-tile ball metadata plus padded bucket row tiles."""
    centroid: torch.Tensor     # (L, d)
    radius: torch.Tensor       # (L,)
    bucket_rows: torch.Tensor  # (L, cap) int64; -1 = padding
    cap: int
    # scales of the certified re-rank's error bounds (host floats)
    cen_max2: float = 0.0      # max |centroid|^2
    rad_max: float = 0.0       # max tile radius

    @property
    def n_leaves(self) -> int:
        return int(self.centroid.shape[0])


def bucket_tiles(starts: np.ndarray, ends: np.ndarray, tile: int = 0
                 ) -> Tuple[np.ndarray, int, np.ndarray]:
    """Padded physical-row tiles from leaf [start, end) ranges.

    tile=0: one tile per leaf, cap = max bucket size. tile>0: each leaf is
    split into fixed ``tile``-row chunks. Returns (rows (T, cap), cap,
    leaf_of_tile (T,)); chunks of one leaf are consecutive, so a stable
    lower-bound sort preserves the scalar executor's bucket visit order.
    """
    starts = np.asarray(starts)
    ends = np.asarray(ends)
    if tile <= 0:
        sizes = ends - starts
        cap = int(sizes.max(initial=1))
        rows = np.full((len(starts), cap), -1, np.int32)
        for i, (s, e) in enumerate(zip(starts, ends)):
            rows[i, :e - s] = np.arange(s, e, dtype=np.int32)
        return rows, cap, np.arange(len(starts), dtype=np.int32)
    chunks: List[np.ndarray] = []
    leaf_of_tile: List[int] = []
    for i, (s, e) in enumerate(zip(starts, ends)):
        for c0 in range(int(s), int(e), tile):
            chunks.append(np.arange(c0, min(c0 + tile, int(e)),
                                    dtype=np.int32))
            leaf_of_tile.append(i)
    if not chunks:  # degenerate: no rows at all
        chunks.append(np.empty(0, np.int32))
        leaf_of_tile.append(0)
    rows = np.full((len(chunks), tile), -1, np.int32)
    for i, c in enumerate(chunks):
        rows[i, :len(c)] = c
    return rows, tile, np.asarray(leaf_of_tile, np.int32)


def _tile_geometry(col: np.ndarray, rows_np: np.ndarray,
                   bucket_rows: torch.Tensor, cap: int) -> LeafGeometry:
    """Per-tile ball (centroid, radius) over the tile's own rows. Host
    numpy, as in the reference, so both packages derive bit-identical
    balls from the same table."""
    valid = rows_np >= 0
    cnt = np.maximum(valid.sum(1), 1)
    pts = np.asarray(col, np.float32)[np.maximum(rows_np, 0)]
    pts = np.where(valid[:, :, None], pts, 0.0)
    cen = pts.sum(1) / cnt[:, None]
    d2 = ((pts - cen[:, None, :]) ** 2).sum(2)
    rad = np.sqrt(np.max(np.where(valid, d2, 0.0), axis=1))
    dev = bucket_rows.device
    return LeafGeometry(
        centroid=torch.as_tensor(cen, dtype=torch.float32, device=dev),
        radius=torch.as_tensor(rad, dtype=torch.float32, device=dev),
        bucket_rows=bucket_rows, cap=cap,
        cen_max2=float((cen.astype(np.float64) ** 2).sum(1).max(initial=0)),
        rad_max=float(rad.max(initial=0)))


def tile_data(col: np.ndarray, bucket_rows: np.ndarray) -> np.ndarray:
    """(n, d) column -> (T, cap, d) tile-major copy (padding rows are row
    0; a tile's validity mask excludes them)."""
    col = np.asarray(col, np.float32)
    safe = np.maximum(np.asarray(bucket_rows), 0)
    return col[safe]


@dataclass
class EngineStats:
    """Aggregate stats for one batch."""
    queries: int = 0
    predicate_buckets: int = 0   # leaves surviving box/ball pruning
    knn_buckets: int = 0         # bucket tiles scanned across beam rounds
    rows_scanned: int = 0        # valid rows fed to the top-k kernel
    knn_rounds: int = 0
    knn_jobs: int = 0            # V.K jobs re-ranked (proven or widened)
    knn_exact_fallbacks: int = 0  # V.K jobs whose re-rank took widen_exact
    vr_tiles_scanned: int = 0    # tiles gathered by the V.R tile planner
    vr_tiles_pruned: int = 0     # tiles dropped by the V.R triangle bound
    vr_dense_fallbacks: int = 0  # V.R groups that took the dense column path
    # mixed-precision scan counters (precision != "fp32"): candidates
    # scanned in reduced precision vs candidates rescored in fp32 —
    # rescued/scanned is the rescue ratio explain() reports
    mp_scanned: int = 0
    mp_rescued: int = 0
    time_s: float = 0.0
    shards: int = 0              # the shard count the device loop ran on
    #                              (0: one device, or the host loop)
    # (archetype, converged width in tiles) per executed KNN group — the
    # feedback signal Session records into QBS for query-aware seeding
    knn_group_widths: List[Tuple[str, int]] = field(default_factory=list)
    # (stage kind, feature vector, observed seconds) per executed stage
    stage_samples: List[Tuple[str, Tuple[float, ...], float]] = \
        field(default_factory=list)


# ---------------------------------------------------------------------------
# Batched exact KNN over bucket tiles (one vector space)
# ---------------------------------------------------------------------------
def _gather_tiles(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(G, T, cap) x (G, w) tile ids -> (G, w, cap)."""
    return torch.gather(t, 1, sel[:, :, None].expand(-1, -1, t.shape[2]))


def _knn_round(act, qs, order, masks_tiles, data_tiles, bucket_rows,
               planes=None, lb_all=None, kth0_all=None, *, w0: int, w1: int,
               k: int, k_stop: int, precision: str = "fp32",
               host_exit: bool = True):
    """One beam round for the ``act`` query subset: scan each query's
    [w0, w1) best-lower-bound tiles with the fused distance+top-k kernel.
    Returns (sq_dists (G, k), physical rows (G, k), valid rows per
    query, fp32-rescued candidates per query, least refuted bounds per
    query (G, 2) by source, as ``ops.topk_l2_masked_mp`` returns them);
    the last two are 0 and +inf on the fp32 path.

    Mixed precision: ``planes`` is the layout's ``TilePlanes`` on the
    device, ``lb_all`` the per-query sorted ball bounds and ``kth0_all``
    (optional, (G_full,)) the carry's ``k_stop``-th squared distance; the
    round scans the narrow codes and rescores the surviving frontier in
    fp32, refuting at rank ``k_stop``; ``host_exit=False`` runs the
    rescue's whole iteration budget without reading its "any live" flag
    on the host (the same rows and counts, and no host sync)."""
    qa = qs[act]
    sel = order[act][:, w0:w1]                            # (G, w)
    g, w = sel.shape
    cand = bucket_rows[sel].reshape(g, -1)                # (G, w*cap)
    valid = cand >= 0
    if masks_tiles is not None:
        valid = valid & _gather_tiles(masks_tiles[act], sel).reshape(g, -1)
    if precision != "fp32":
        cap = bucket_rows.shape[1]
        lb_col = lb_all[act][:, w0:w1]
        lb2 = (lb_col * lb_col).repeat_interleave(cap, dim=1)
        kth0 = None if kth0_all is None else kth0_all[act]
        d2, idx, resc, refuted = ops.topk_l2_masked_mp(
            qa, sel, valid, data_tiles, *planes, k, lb2=lb2, kth0=kth0,
            precision=precision, k_rescue=k_stop, host_exit=host_exit)
    else:
        pts = data_tiles[sel].reshape(g, -1, data_tiles.shape[-1])
        d2, idx = ops.topk_l2_masked(qa, pts, valid, k)
        resc = torch.zeros(g, dtype=torch.int64, device=qs.device)
        refuted = torch.full((g, 2), _INF, device=qs.device)
    rows = torch.gather(cand, 1, idx.clamp_min(0))
    rows = torch.where(idx >= 0, rows, torch.full_like(rows, -1))
    return d2, rows, valid.sum(1), resc, refuted


def _tile_masks(masks, bucket_rows):
    """Re-layout per-row masks (G, n) into tile-major (G, T, cap) once per
    KNN group, so beam rounds gather masks by tile index."""
    t, cap = bucket_rows.shape
    flat = bucket_rows.reshape(-1).clamp_min(0)
    return masks[:, flat].reshape(masks.shape[0], t, cap)


def _lower_bounds(qs, centroid, radius, masks_tiles):
    d2c = ops.pairwise_sq_l2(qs, centroid)
    dc = torch.sqrt(torch.clamp_min(d2c, 0.0))
    lb = torch.clamp_min(dc - radius[None, :], 0.0)       # (G, L)
    if masks_tiles is not None:
        lb = torch.where(masks_tiles.any(dim=2), lb,
                         torch.full_like(lb, _INF))
    return lb


def _knn_prologue(qs, centroid, radius, masks_tiles=None):
    """Per-query tile lower bounds, visit order, and sorted bounds.

    With a row mask, tiles holding NO masked rows get lb = +inf: they
    sort last and the stopping bound treats them as exhausted."""
    lb = _lower_bounds(qs, centroid, radius, masks_tiles)
    order = torch.argsort(lb, dim=1, stable=True)
    return order, torch.gather(lb, 1, order)


def _knn_prologue_fast(qs, centroid, radius, masks_tiles=None):
    """``_knn_prologue`` with a packed single-key sort (below 4096 tiles,
    ``_sort_packed``)."""
    return _sort_packed(_lower_bounds(qs, centroid, radius, masks_tiles))


def _sort_packed(lb):
    """Each row of ``lb`` (at most 4096 columns) sorted by one packed key.

    The fp32 bound's bit pattern is order-preserving for non-negative
    floats, so bound and tile index share one int32 key: the low 12
    mantissa bits are truncated and replaced by the tile index.
    Truncation only lowers the reported bound, so the stopping rule stays
    conservative; near-equal bounds order by tile index. Returns (order,
    sorted bounds)."""
    bits = lb.contiguous().view(torch.int32)
    l = lb.shape[1]
    key = (bits & ~4095) | torch.arange(l, dtype=torch.int32,
                                        device=lb.device)[None, :]
    key = torch.sort(key, dim=1).values
    order = (key & 4095).to(torch.int64)
    lb_sorted = (key & ~4095).contiguous().view(torch.float32)
    return order, lb_sorted


def batched_knn(geom: LeafGeometry, data_tiles, qs, k: int, *,
                masks: Optional[torch.Tensor] = None, beam: int = 8,
                k_stop: Optional[int] = None, planes=None,
                precision: str = "fp32",
                stats: Optional[EngineStats] = None,
                conv_out: Optional[list] = None,
                next_lb_out: Optional[list] = None,
                refuted_out: Optional[list] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact batched (optionally row-masked) KNN, host doubling loop.

    qs: (G, d) tensor; data_tiles: (T, cap, d) tile-major copy of the
    column; masks: optional (G, n) bool. Returns (dists (G, k) fp32 L2,
    rows (G, k) int64; -1/inf pad slots). A query's result is final once
    its ``k_stop``-th (default k) distance <= the next unscanned lower
    bound — the scalar executor's stopping rule; the beam doubles (a
    round scans at most ``_round_tiles`` new tiles for the queries still
    active) and finished queries leave the batch. ``conv_out`` receives
    each query's
    converged beam width (the QBS convergence signal), ``next_lb_out``
    the least lower bound among its unscanned tiles (+inf: none left),
    ``refuted_out`` the least squared bounds (G, 2) among the candidates
    the mixed-precision rescue refuted, by source as
    ``ops.topk_l2_masked_mp`` splits them (+inf: none; always on fp32)."""
    t0 = time.time()
    k_stop = k if k_stop is None else k_stop
    dev = data_tiles.device
    qs = qs.float()
    masks_tiles = None
    if masks is not None:
        masks_tiles = _tile_masks(masks, geom.bucket_rows)
    g = int(qs.shape[0])
    l = geom.n_leaves
    prologue = _knn_prologue_fast if l <= 4096 else _knn_prologue
    order, lb_dev = prologue(qs, geom.centroid, geom.radius, masks_tiles)
    lb_sorted = lb_dev.cpu().numpy()
    best_d2 = np.full((g, k), np.inf, np.float32)
    best_r = np.full((g, k), -1, np.int64)
    conv = np.zeros(g, np.int64)
    next_lb = np.full(g, np.inf, np.float32)
    refuted = np.full((g, 2), np.inf, np.float32)
    active = np.arange(g)
    w0, w = 0, max(1, min(beam, l, _round_tiles(_next_pow2(g), data_tiles,
                                                 planes)))
    first = True
    while len(active):
        na = len(active)
        gp = _next_pow2(na)
        padded = np.zeros(gp, np.int64)
        padded[:na] = active
        kth0_all = None
        if precision != "fp32" and not first:
            # the carry's k_stop-th squared distance refutes from the
            # rescue's first iteration
            kth0_all = torch.as_tensor(best_d2[:, k_stop - 1], device=dev)
        d2, rows, nvalid, resc, rlb = _knn_round(
            torch.as_tensor(padded, device=dev), qs, order, masks_tiles,
            data_tiles, geom.bucket_rows, planes, lb_dev, kth0_all, w0=w0,
            w1=w, k=k, k_stop=k_stop, precision=precision)
        first = False
        d2 = d2[:na].cpu().numpy()
        rows = rows[:na].cpu().numpy()
        refuted[active] = np.minimum(refuted[active], rlb[:na].cpu().numpy())
        if stats is not None:
            stats.knn_rounds += 1
            stats.knn_buckets += na * (w - w0)
            nv = int(nvalid[:na].sum())
            stats.rows_scanned += nv
            if precision != "fp32":
                stats.mp_scanned += nv
                stats.mp_rescued += int(resc[:na].sum())
        # host merge with the carry: carried entries come from earlier
        # (lower-lb) buckets, so a stable sort keeps the visit-order
        # tie-break
        alld = np.concatenate([best_d2[active], d2], axis=1)
        allr = np.concatenate([best_r[active], rows], axis=1)
        pick = np.argsort(alld, axis=1, kind="stable")[:, :k]
        merged_d = np.take_along_axis(alld, pick, axis=1)
        merged_r = np.take_along_axis(allr, pick, axis=1)
        best_d2[active] = merged_d
        best_r[active] = merged_r
        kth = np.sqrt(merged_d[:, k_stop - 1])
        nxt = lb_sorted[active, w] if w < l else np.full(na, np.inf)
        done = (kth <= nxt) | (w >= l)
        conv[active[done]] = w
        next_lb[active[done]] = nxt[done]
        active = active[~done]
        most = _round_tiles(_next_pow2(max(1, len(active))), data_tiles,
                            planes)
        w0, w = w, min(2 * w, l, w + most)
    if stats is not None:
        stats.time_s += time.time() - t0
    if conv_out is not None:
        conv_out.append(conv)
    if next_lb_out is not None:
        next_lb_out.append(next_lb)
    if refuted_out is not None:
        refuted_out.append(refuted)
    return np.sqrt(best_d2), best_r


def _knn_device_loop(idx, active0, qs_full, d2_full, rows_full, order,
                     lb_sorted, masks_tiles, data_tiles, bucket_rows,
                     planes=None, *, w1: int, w: int, budget: int, k: int,
                     k_stop: int, precision: str = "fp32"):
    """The straggler beam loop. ``idx`` selects the straggler subset
    (padded to a power of two; ``active0`` marks the real rows) out of
    the full-batch arrays; the first round's (d2, rows) seed the top-k
    carry, and each straggler keeps its remaining visit order (columns
    past ``w1``) padded to the static budget*w width with tile-0 columns
    whose +inf lower bound kills them. The reference runs this as one
    ``lax.while_loop``; here the host reads the (G,) active mask once
    per round to evaluate the same condition. Returns (best_d2,
    best_rows, [rounds, buckets_scanned, rows_scanned, rescued],
    per-query retirement round, per-query least refuted bounds (G, 2))."""
    l = order.shape[1]
    cap = bucket_rows.shape[1]
    qs = qs_full[idx]
    bd = d2_full[idx]
    br = rows_full[idx]
    order_pad = F.pad(order[idx][:, w1:], (0, budget * w - (l - w1)))
    lb_pad = F.pad(lb_sorted[idx][:, w1:], (0, budget * w + 1 - (l - w1)),
                   value=_INF)
    if masks_tiles is not None:
        masks_tiles = masks_tiles[idx]
    g = qs.shape[0]
    dev = qs.device
    active = active0.clone()
    rr = torch.zeros(g, dtype=torch.int64, device=dev)
    nbuck = torch.zeros((), dtype=torch.int64, device=dev)
    nrows = torch.zeros((), dtype=torch.int64, device=dev)
    nresc = torch.zeros((), dtype=torch.int64, device=dev)
    refuted = torch.full((g, 2), _INF, device=dev)
    r = 0
    while r < budget and bool(active.any()):
        start = r * w
        sel = order_pad[:, start:start + w]
        lb_col = lb_pad[:, start:start + w]
        # columns whose lower bound is +inf are padding, or real tiles
        # with no mask-surviving rows — neither can contribute a row
        colv = ~torch.isinf(lb_col)                       # (G, w)
        cand = bucket_rows[sel].reshape(g, -1)            # (G, w*cap)
        valid = ((cand >= 0) & colv.repeat_interleave(cap, dim=1)
                 & active[:, None])
        if masks_tiles is not None:
            valid = valid & _gather_tiles(masks_tiles, sel).reshape(g, -1)
        # per-candidate squared tile bounds: the kernel's chunk early-out
        lb2 = (lb_col * lb_col).repeat_interleave(cap, dim=1)
        if precision != "fp32":
            # the carry's k_stop-th squared distance refutes quantized
            # candidates before any fp32 rescore
            d2, ix, resc, rlb = ops.topk_l2_masked_mp(
                qs, sel, valid, data_tiles, *planes, k, lb2=lb2,
                kth0=bd[:, k_stop - 1], precision=precision,
                k_rescue=k_stop)
            nresc = nresc + resc.sum()
            refuted = torch.minimum(refuted, rlb)
        else:
            pts = data_tiles[sel].reshape(g, -1, data_tiles.shape[-1])
            d2, ix = ops.topk_l2_masked(qs, pts, valid, k, lb2=lb2)
        rows = torch.gather(cand, 1, ix.clamp_min(0))
        rows = torch.where(ix >= 0, rows, torch.full_like(rows, -1))
        # merge with the carry: carry first and a stable top-k, so earlier
        # (lower-lb) tiles keep the visit-order tie-break; inactive
        # queries contribute only +inf candidates (valid was zeroed)
        md, pick = stable_topk(torch.cat([bd, d2], dim=1), k)
        mr = torch.gather(torch.cat([br, rows], dim=1), 1, pick)
        kth = torch.sqrt(md[:, k_stop - 1])
        nxt = lb_pad[:, start + w]
        active2 = active & ~(kth <= nxt)
        rr = torch.where(active & ~active2, r + 1, rr)
        nbuck = nbuck + (colv & active[:, None]).sum()
        nrows = nrows + valid.sum()
        bd, br, active = md, mr, active2
        r += 1
    rr = torch.where(active, r, rr)  # budget-exhausted: scanned everything
    return bd, br, (r, int(nbuck), int(nrows), int(nresc)), rr, refuted


def _knn_start(qs, masks_tiles, centroid, radius, data_tiles, bucket_rows,
               planes=None, *, w1: int, k: int, k_stop: int,
               precision: str = "fp32"):
    """Prologue + first beam round over the full batch + the stopping
    rule: a query stays active iff its ``k_stop``-th distance exceeds the
    next unscanned lower bound. Everything it returns stays on the device
    (the valid-row and rescue sums as 0-d tensors) and it takes no host
    sync: the mixed-precision rescue runs its whole iteration budget."""
    g = qs.shape[0]
    prologue = _knn_prologue_fast if centroid.shape[0] <= 4096 \
        else _knn_prologue
    order, lb_sorted = prologue(qs, centroid, radius, masks_tiles)
    l = lb_sorted.shape[1]
    d2, rows, nvalid, resc, refuted = _knn_round(
        torch.arange(g, device=qs.device), qs, order, masks_tiles,
        data_tiles, bucket_rows, planes, lb_sorted, None, w0=0, w1=w1, k=k,
        k_stop=k_stop, precision=precision, host_exit=False)
    kth = torch.sqrt(d2[:, k_stop - 1])
    nxt = lb_sorted[:, w1] if w1 < l else \
        torch.full((g,), _INF, device=qs.device)
    return (order, lb_sorted, d2, rows, kth > nxt, nvalid.sum(),
            resc.sum(), refuted)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without a host sync: a pinned staging copy
    and a non-blocking upload on the current stream (a copy from pageable
    memory waits for the stream). The caching host allocator keeps the
    staging memory until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy of ``t`` into pinned memory on the
    current stream (a copy into pageable memory is synchronous); read it
    after an event recorded behind it. A CPU tensor is returned as is."""
    if not t.is_cuda:
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


class _PendingDeviceKnn:
    """Deferred half of ``batched_knn_device_async``: the prologue and the
    fused first round are enqueued and their results are on their way to
    pinned host memory; ``finish()`` waits for them (the one fence), runs
    the straggler loop and returns the rows. Idempotent."""

    __slots__ = ("_fn", "_out")

    def __init__(self, fn):
        self._fn = fn
        self._out = None

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._out is None:
            self._out = self._fn()
        return self._out


class _ReadyKnn:
    """A finished KNN standing in for ``_PendingDeviceKnn`` (the host
    loop, which runs at dispatch)."""

    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._out


def batched_knn_device_async(
        geom: LeafGeometry, data_tiles, qs, k: int, *,
        masks: Optional[torch.Tensor] = None, beam: int = 8,
        w1: Optional[int] = None, ws: Optional[int] = None,
        k_stop: Optional[int] = None, planes=None, precision: str = "fp32",
        stats: Optional[EngineStats] = None,
        conv_out: Optional[list] = None,
        next_lb_out: Optional[list] = None,
        refuted_out: Optional[list] = None) -> _PendingDeviceKnn:
    """Dispatch half of ``batched_knn_device``: enqueues the prologue and
    the fused first round on the current stream, starts the copies of
    what the straggler loop reads (the (G,) active mask, the first
    round's distances, rows, refuted bounds and counters) into pinned
    host memory, records an event behind them and returns, with no host
    sync (``_knn_start``). ``finish()`` of the result waits on the event and returns what
    ``batched_knn_device`` returns; stats and the ``*_out`` lists are
    written there."""
    t0 = time.time()
    k_stop = k if k_stop is None else k_stop
    dev = data_tiles.device
    qs = qs.float()
    masks_tiles = None
    if masks is not None:
        masks_tiles = _tile_masks(masks, geom.bucket_rows)
    g = int(qs.shape[0])
    l = geom.n_leaves
    w1 = max(1, min(w1 if w1 else max(1, beam // 2), l,
                    _round_tiles(g, data_tiles, planes)))
    order, lb_sorted, d2, rows, active, nvalid, resc, refuted = _knn_start(
        qs, masks_tiles, geom.centroid, geom.radius, data_tiles,
        geom.bucket_rows, planes, w1=w1, k=k, k_stop=k_stop,
        precision=precision)
    host = [_to_host_async(t) for t in (active, d2, rows, refuted, nvalid,
                                        resc)]
    ready = None
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    t_disp = time.time() - t0

    def _finish() -> Tuple[np.ndarray, np.ndarray]:
        t1 = time.time()
        if ready is not None:
            ready.synchronize()
        active_h, d2f, rowsf, refuted_h, nvalid_h, resc_h = (
            x.numpy() for x in host)
        if stats is not None:
            stats.knn_rounds += 1
            stats.knn_buckets += g * w1
            stats.rows_scanned += int(nvalid_h)
            if precision != "fp32":
                stats.mp_scanned += int(nvalid_h)
                stats.mp_rescued += int(resc_h)
        conv = np.full(g, w1, np.int64)
        act = np.nonzero(active_h)[0]
        refuted_f = refuted_h
        if len(act) and w1 < l:
            na = len(act)
            gp = _next_pow2(na)
            padded = np.zeros(gp, np.int64)
            padded[:na] = act
            idx = torch.as_tensor(padded, device=dev)
            active0 = torch.as_tensor(np.arange(gp) < na, device=dev)
            w = max(1, min(ws if ws else beam,
                           _round_tiles(gp, data_tiles, planes)))
            budget = -(-(l - w1) // w)
            bd, br, (rounds, nbuck, nrows, nresc), retire_round, rlb = \
                _knn_device_loop(
                    idx, active0, qs, d2, rows, order, lb_sorted,
                    masks_tiles, data_tiles, geom.bucket_rows, planes,
                    w1=w1, w=w, budget=budget, k=k, k_stop=k_stop,
                    precision=precision)
            refuted_f = refuted_h.copy()
            refuted_f[act] = np.minimum(refuted_f[act],
                                        rlb[:na].cpu().numpy())
            d2f = d2f.copy()
            rowsf = rowsf.copy()
            d2f[act] = bd[:na].cpu().numpy()
            rowsf[act] = br[:na].cpu().numpy()
            conv[act] = np.minimum(
                w1 + retire_round[:na].cpu().numpy().astype(np.int64) * w,
                l)
            if stats is not None:
                stats.knn_rounds += rounds
                stats.knn_buckets += nbuck
                stats.rows_scanned += nrows
                if precision != "fp32":
                    stats.mp_scanned += nrows
                    stats.mp_rescued += nresc
        if stats is not None:
            stats.time_s += t_disp + (time.time() - t1)
        if conv_out is not None:
            conv_out.append(conv)
        if next_lb_out is not None:
            # the least bound among tiles that may hold left-out rows:
            # tiles past each query's converged width, and scanned tiles
            # whose rows the lb2 early-out may have skipped (bound^2 at or
            # above the final k-th expansion distance, which no running
            # k-th undercuts)
            lbs = F.pad(lb_sorted, (0, 1), value=_INF).double()
            thr = np.sqrt(d2f[:, -1].astype(np.float64) * (1 - 4 * _U32))
            pos = torch.minimum(
                torch.searchsorted(lbs, torch.as_tensor(
                    thr, device=dev)[:, None]),
                torch.as_tensor(conv, device=dev)[:, None])
            next_lb_out.append(
                torch.gather(lbs, 1, pos)[:, 0].cpu().numpy())
        if refuted_out is not None:
            refuted_out.append(refuted_f)
        return np.sqrt(d2f), rowsf.astype(np.int64)

    return _PendingDeviceKnn(_finish)


def batched_knn_device(geom: LeafGeometry, data_tiles, qs, k: int, *,
                       masks: Optional[torch.Tensor] = None, beam: int = 8,
                       w1: Optional[int] = None, ws: Optional[int] = None,
                       k_stop: Optional[int] = None, planes=None,
                       precision: str = "fp32",
                       stats: Optional[EngineStats] = None,
                       conv_out: Optional[list] = None,
                       next_lb_out: Optional[list] = None,
                       refuted_out: Optional[list] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact batched (optionally row-masked) KNN with the beam loop on
    the device: same contract and rows as ``batched_knn``.

    ONE fused first round scans every query's top beam/2 lower-bound
    tiles; one (G,) active-mask read compacts the stragglers (padded to
    a power of two) and the straggler loop runs rounds of ``ws`` (default
    beam; at most ``_round_tiles``) tiles with the static budget
    ceil(remaining / ws), retiring
    queries by the same bound check. ``conv_out`` receives per-query
    converged widths: w1 for queries the first round finished, w1 + r*ws
    for a straggler retired in loop round r (capped at the tile count);
    ``next_lb_out`` the least lower bound among tiles that may hold rows
    the scan left out (+inf: none), ``refuted_out`` as in
    ``batched_knn``. The dispatch half (``batched_knn_device_async``)
    and its ``finish()`` back to back."""
    return batched_knn_device_async(
        geom, data_tiles, qs, k, masks=masks, beam=beam, w1=w1, ws=ws,
        k_stop=k_stop, planes=planes, precision=precision, stats=stats,
        conv_out=conv_out, next_lb_out=next_lb_out,
        refuted_out=refuted_out).finish()


def _rerank_certified(t_k: float, m: float, next_lb: float, qq: float,
                      dim: int, pmax2: float, cmax2: float,
                      rmax: float, refuted_q: float = _INF,
                      refuted_b: float = _INF) -> bool:
    """Whether a job's re-ranked candidates hold the oracle's top-k.

    ``t_k`` is the k-th exact squared distance among the candidates (+inf
    with fewer than k), ``m`` the expansion's squared distance in the last
    candidate slot (+inf if empty), ``next_lb`` the least bound of the
    tiles that may hold rows the scan left out (unscanned, or skipped by
    the kernel's lb2 early-out), ``refuted_q`` and ``refuted_b`` the
    least squared bounds among the candidates the mixed-precision rescue
    refuted (+inf: none), split by source. A row left out was ranked past
    the last slot by the kernel (expansion >= m), lies behind such a tile
    bound, or was refuted. The bound on its distance takes off the
    expansion's error (``e_row``); for a tile bound b, the centroid
    distance's error (``e_cen``, which moves b by at most e_cen / b) and
    the rounding of b and of the tile radius; and the oracle's own
    rounding comes off the result. A refuted candidate's bound is the
    quantized scan's (``refuted_q``), already a lower bound on its exact
    squared distance but for the rounding of its final square, or its
    tile's ball bound where that was larger (``refuted_b``), which takes
    the tile bound's corrections. Ties fail the proof."""
    e_row = 4 * dim * _U32 * (qq + pmax2)
    e_cen = 4 * dim * _U32 * (qq + cmax2)

    def floor(b: float) -> float:   # a tile bound net of its errors
        if 0.0 < b < _INF:
            b = max(0.0, b - e_cen / b - (dim + 8) * _U32 * (b + 2 * rmax))
        return max(b, 0.0) ** 2
    # m came back as an fp32 sqrt, squared
    lo = min(m * (1 - 4 * _U32) - e_row, floor(next_lb),
             refuted_q * (1 - 2 * _U32), floor(math.sqrt(refuted_b)))
    if math.isinf(t_k):
        return math.isinf(lo)
    return t_k < lo * (1 - (dim + 2) * _U32)


def rerank_exact(x: np.ndarray, qv: np.ndarray, dist: np.ndarray,
                 rows: np.ndarray, next_lb: float, k: int, pmax2: float,
                 geom: LeafGeometry,
                 refuted: Tuple[float, float] = (_INF, _INF)
                 ) -> Tuple[np.ndarray, bool, float]:
    """A scan's candidates (``rows`` of the column ``x``, with the
    kernel's L2 ``dist``) re-ranked by the oracle's own formula and its
    tie law (exactly equal distances order by row id). ``pmax2`` is the
    column's max |row|^2 padded against its rounding, ``geom`` the
    scanned layout. Returns (top-k rows, whether ``_rerank_certified``
    proves them complete, the k-th exact squared distance)."""
    cand = rows[rows >= 0]
    d2 = np.sum((x[cand] - qv[None, :]) ** 2, axis=1)
    order = np.lexsort((cand, d2))
    t_k = float(d2[order[k - 1]]) if len(cand) >= k else _INF
    q64 = qv.astype(np.float64)
    ok = _rerank_certified(t_k, float(dist[-1]) ** 2, float(next_lb),
                           float(q64 @ q64), len(qv), pmax2, geom.cen_max2,
                           geom.rad_max, float(refuted[0]),
                           float(refuted[1]))
    return cand[order[:k]], ok, t_k


def widen_exact(x: np.ndarray, x_dev: torch.Tensor, qs: torch.Tensor,
                qv: np.ndarray, masks: Optional[torch.Tensor], fails,
                pmax2: float) -> List[np.ndarray]:
    """Exact rows for the jobs whose re-rank was not proven, from one
    pairwise pass of their queries over the whole column (``x`` on the
    host, ``x_dev`` on the device). Each job's k-th exact candidate
    distance ``t_k`` bounds the oracle's k-th from above, so every oracle
    row has an expansion distance within t_k plus the fp32 errors; the
    rows within that threshold (and the job's mask) are re-ranked by the
    oracle's formula. ``fails`` holds (position in ``qs``, k, t_k); one
    row array per failure comes back."""
    pos = [f[0] for f in fails]
    dim = qv.shape[1]
    q64 = qv[pos].astype(np.float64)
    e_row = 4 * dim * _U32 * ((q64 * q64).sum(1) + pmax2)
    t_k = np.asarray([f[2] for f in fails])
    # the (1 + 4u) factor keeps the fp32 cast from rounding it down
    thr = (t_k / (1 - (dim + 2) * _U32) + e_row) * (1 + 4 * _U32)
    sel = torch.as_tensor(pos, device=x_dev.device)
    hit = ops.pairwise_sq_l2(qs[sel], x_dev) <= torch.as_tensor(
        thr, dtype=torch.float32, device=x_dev.device)[:, None]
    if masks is not None:
        hit &= masks[sel]
    at = torch.nonzero(hit).cpu().numpy()
    out = []
    for j, (p, k, _) in enumerate(fails):
        cand = at[at[:, 0] == j, 1]
        d2 = np.sum((x[cand] - qv[p][None, :]) ** 2, axis=1)
        out.append(cand[np.lexsort((cand, d2))[:k]])
    return out


class _PendingJobs:
    """Deferred half of ``HybridEngine._dispatch_jobs``: per-group
    finishers run in dispatch order. ``finish()`` is idempotent and
    returns the per-job rows ``_run_jobs`` returns."""

    __slots__ = ("_finishers", "_out", "_done")

    def __init__(self, n_jobs: int):
        self._finishers: list = []
        self._out: List[Optional[np.ndarray]] = [None] * n_jobs
        self._done = False

    def add(self, fn) -> None:
        self._finishers.append(fn)

    def run_now(self, fn) -> None:
        """Eager mode: one group's finisher, right at its dispatch."""
        fn(self._out)

    def finish(self) -> List[np.ndarray]:
        if not self._done:
            for fn in self._finishers:
                fn(self._out)
            self._done = True
        return self._out  # type: ignore[return-value]


class PendingBatch:
    """Deferred epilogue of ``HybridEngine.execute_batch_async``:
    ``materialize()`` waits for the batch's device work and returns the
    (rows, stats) the synchronous call returns. Idempotent."""

    __slots__ = ("_fn", "_res")

    def __init__(self, fn):
        self._fn = fn
        self._res = None

    def materialize(self):
        if self._res is None:
            self._res = self._fn()
        return self._res


# ---------------------------------------------------------------------------
# Sharded execution (the tile-major layout sharded along T)
# ---------------------------------------------------------------------------
# The tile axis is the shard axis: tiles are self-contained (ball, row ids,
# data rows), so splitting T over a ``TileMesh`` gives shared-nothing
# partitions whose only cross-talk is a per-round k-way merge of (G, k)
# heaps. Layout (``sharding.partitioning``): the padded tile axis is
# permuted strided (tile t -> shard t mod S); pad tiles are dead (lower
# bound +inf, invisible to every pruning rule). Delta tiles (ingest) are
# not sharded: every shard sees them after its own tiles, and only shard
# 0's copies are live, so the delta keeps the single-device loop's
# freshness with no row on two shards.
#
# Shards that share one device share the layout's arrays: a shard is a
# list of tile indices into them (``ShardedTiles.local``), and the S local
# scans of a round run as one kernel launch over S*G rows (shard-major:
# row s*G + g), each gathering its own tiles. Each shard keeps its own
# LOCAL top-k heap over its own (disjoint) tiles; every round ends with
# the merge: all_gather the S local heaps in shard order and keep the best
# k with one ``stable_topk`` over (G, S*k), which gives the GLOBAL heap. A
# query retires when its global k_stop-th distance is at most the least,
# over shards (pmin), of the next unscanned LOCAL lower bound, which is
# the next unscanned GLOBAL bound: the scalar executor's stopping rule.
# Keeping local heaps local is what makes the merge exact: merging the
# global heap back into shard carries would put rows on two shards and let
# copies crowd out true neighbours. The engine's certified re-rank then
# orders the candidates as the oracle does, so every shard count returns
# the single-device rows.
@dataclass
class ShardedTiles:
    """A tile layout's placement over a ``TileMesh``, as indices into the
    layout's own arrays (its ``t_base`` base tiles, then ``td`` delta
    tiles): ``local[s, j]`` is shard s's j-th tile, base tiles strided
    then the delta's, which every shard sees and only shard 0's are
    ``live``. Pad slots point at tile 0 and are not live; a slot that is
    not live bounds +inf, so no scan reads it."""
    mesh: TileMesh
    perm: np.ndarray           # padded position -> base tile (>= t_base: pad)
    t_local: int
    t_base: int
    td: int
    local_np: np.ndarray       # (S, t_local + td) int64
    live_np: np.ndarray        # (S, t_local + td) bool
    local: torch.Tensor
    live: torch.Tensor

    @property
    def shards(self) -> int:
        return self.mesh.shards

    @property
    def t_total(self) -> int:
        """Tiles each shard's scan sees (its own plus the delta's)."""
        return self.t_local + self.td


def shard_tiles(mesh: TileMesh, t_base: int, td: int = 0) -> ShardedTiles:
    """The strided placement of ``t_base`` base tiles over ``mesh``, with
    ``td`` delta tiles (indices ``t_base ...``) seen after every shard's
    own and live on shard 0 only."""
    s = mesh.shards
    perm, tl, _ = strided_tile_layout(t_base, s)
    pad = (perm >= t_base).reshape(s, tl)
    local = np.empty((s, tl + td), np.int64)
    local[:, :tl] = np.where(pad, 0, perm.reshape(s, tl))
    local[:, tl:] = t_base + np.arange(td)
    live = np.ones((s, tl + td), bool)
    live[:, :tl] = ~pad
    live[1:, tl:] = False
    return ShardedTiles(
        mesh=mesh, perm=perm, t_local=tl, t_base=t_base, td=td,
        local_np=local, live_np=live,
        local=shard_put(local.reshape(-1), mesh),
        live=shard_put(live.reshape(-1), mesh))


def _sharded_tile_masks(masks: Optional[torch.Tensor], st: ShardedTiles,
                        bucket_rows: torch.Tensor):
    """Per-row masks (G, n) as each shard's tile-major (S, G, L, cap)."""
    if masks is None:
        return None
    s, l = st.shards, st.t_total
    g = masks.shape[0]
    cap = bucket_rows.shape[1]
    flat = bucket_rows[st.local].reshape(-1).clamp_min(0)
    return masks[:, flat].view(g, s, l, cap).transpose(0, 1).contiguous()


def _sharded_prologue(qs, st: ShardedTiles, geom: LeafGeometry, mt):
    """Each shard's tile lower bounds for every query, sorted: (order,
    sorted bounds), both (S, G, L). One distance launch covers every
    tile's centroid; slots that are not live, and tiles with no masked
    row, bound +inf."""
    s, l = st.shards, st.t_total
    g = qs.shape[0]
    d2c = ops.pairwise_sq_l2(qs, geom.centroid)
    dc = torch.sqrt(torch.clamp_min(d2c, 0.0))[:, st.local]   # (G, S, L)
    rad = torch.where(st.live, geom.radius[st.local],
                      torch.full_like(st.local, -_INF, dtype=torch.float32))
    lb = torch.clamp_min(dc - rad[None], 0.0).transpose(0, 1)
    if mt is not None:
        lb = torch.where(mt.any(dim=3), lb, torch.full_like(lb, _INF))
    lb = lb.reshape(s * g, l)
    if l <= 4096:
        order, lb_sorted = _sort_packed(lb)
    else:
        order = torch.argsort(lb, dim=1, stable=True)
        lb_sorted = torch.gather(lb, 1, order)
    return order.view(s, g, l), lb_sorted.view(s, g, l)


def _shard_heap_merge(coll, lbd, lbr, k: int):
    """The k-way merge of the shards' local heaps (S, G, k): gather them
    in shard order (the deterministic tie-break) and keep the best k of
    each query's S*k with one ``stable_topk``. Local heaps cover disjoint
    rows, so the result is the exact top-k of everything scanned."""
    ad = coll.all_gather(lbd)
    ar = coll.all_gather(lbr)
    s, g, _ = ad.shape
    ad = ad.transpose(0, 1).reshape(g, s * k)
    ar = ar.transpose(0, 1).reshape(g, s * k)
    d, pick = stable_topk(ad, k)
    return d, torch.gather(ar, 1, pick)


def _sharded_local_scan(st: ShardedTiles, lay, qs_rep, sel, colv, act, lbd,
                        lbr, mt, k: int, k_stop: int, lb_col=None,
                        precision: str = "fp32", kth0=None,
                        host_exit: bool = True):
    """Every shard's beam scan of its selected local tiles ``sel`` (S, G, w)
    of the layout ``lay`` (bucket rows, data tiles, planes) as one launch
    over S*G rows (``qs_rep``: the queries repeated
    shard-major), merged into each shard's LOCAL heap (S, G, k), carry
    first, so earlier (lower-bound) tiles keep the visit-order tie-break.
    ``colv`` (S, G, w) marks real columns, ``act`` (G,) the active
    queries, ``lb_col`` (S, G, w) the tiles' bounds (the kernel's early-out
    and, on a reduced-precision scan, the rescue's ball bounds), ``kth0``
    (G,) the previous round's GLOBAL k_stop-th squared distance (reduced
    precision: it refutes from the rescue's first iteration). Returns
    (local d2 and rows (S, G, k), valid rows (S, G), rescued (S, G),
    least refuted bounds (S, G, 2))."""
    bucket_rows, data_tiles, planes = lay
    s, g, w = sel.shape
    cap = bucket_rows.shape[1]
    r = s * g
    dev = qs_rep.device
    fsel = torch.gather(st.local[:, None, :].expand(s, g, -1), 2,
                        sel).reshape(r, w)
    cand = bucket_rows[fsel].reshape(r, w * cap)
    valid = (cand >= 0) & colv.reshape(r, w).repeat_interleave(cap, dim=1)
    if act is not None:
        valid = valid & act.repeat(s)[:, None]
    if mt is not None:
        valid = valid & _gather_tiles(mt.reshape(r, -1, cap),
                                      sel.reshape(r, w)).reshape(r, -1)
    lb2 = None
    if lb_col is not None:
        lb2 = (lb_col * lb_col).reshape(r, w).repeat_interleave(cap, dim=1)
    if precision != "fp32":
        d2, idx, resc, refuted = ops.topk_l2_masked_mp(
            qs_rep, fsel, valid, data_tiles, *planes, k, lb2=lb2,
            kth0=None if kth0 is None else kth0.repeat(s),
            precision=precision, k_rescue=k_stop, host_exit=host_exit)
    else:
        pts = data_tiles[fsel].reshape(r, w * cap, -1)
        d2, idx = ops.topk_l2_masked(qs_rep, pts, valid, k, lb2=lb2)
        resc = torch.zeros(r, dtype=torch.int64, device=dev)
        refuted = torch.full((r, 2), _INF, device=dev)
    rows = torch.gather(cand, 1, idx.clamp_min(0))
    rows = torch.where(idx >= 0, rows, torch.full_like(rows, -1))
    md, pick = stable_topk(torch.cat([lbd.reshape(r, k), d2], dim=1), k)
    mr = torch.gather(torch.cat([lbr.reshape(r, k), rows], dim=1), 1, pick)
    return (md.view(s, g, k), mr.view(s, g, k), valid.sum(1).view(s, g),
            resc.view(s, g), refuted.view(s, g, 2))


def _sharded_start(st: ShardedTiles, geom: LeafGeometry, lay, qs, masks, *,
                   w1: int, k: int, k_stop: int, precision: str):
    """The mask relayout, each shard's prologue, its first round of ``w1``
    local tiles (global coverage S*w1), the merge and the stopping rule:
    a query stays active iff its global k_stop-th distance exceeds the
    pmin over shards of the next local bound."""
    coll = st.mesh.collectives
    s, l = st.shards, st.t_total
    g = qs.shape[0]
    dev = qs.device
    mt = _sharded_tile_masks(masks, st, geom.bucket_rows)
    order, lb_sorted = _sharded_prologue(qs, st, geom, mt)
    qs_rep = qs.repeat(s, 1)
    lbd = torch.full((s, g, k), _INF, device=dev)
    lbr = torch.full((s, g, k), -1, dtype=torch.int64, device=dev)
    colv = ~torch.isinf(lb_sorted[..., :w1])
    lbd, lbr, nvalid, resc, refuted = _sharded_local_scan(
        st, lay, qs_rep, order[..., :w1], colv, None, lbd, lbr, mt, k, k_stop,
        lb_col=lb_sorted[..., :w1] if precision != "fp32" else None,
        precision=precision, host_exit=False)
    gbd, gbr = _shard_heap_merge(coll, lbd, lbr, k)
    kth = torch.sqrt(gbd[:, k_stop - 1])
    nxt = coll.pmin(lb_sorted[..., w1]) if w1 < l else \
        torch.full((g,), _INF, device=dev)
    return (order, lb_sorted, mt, lbd, lbr, gbd, gbr, kth > nxt,
            coll.psum(nvalid.sum(1)), coll.psum(resc.sum(1)),
            coll.pmin(refuted))


def _sharded_loop(st: ShardedTiles, lay, idx, active0, qs_f, lbd_f, lbr_f,
                  order_f, lb_f, mt_f, *, w1: int, w: int, budget: int,
                  k: int, k_stop: int, precision: str = "fp32"):
    """The sharded straggler loop over the compacted stragglers ``idx``
    (padded to a power of two; ``active0`` marks the real rows): each
    round every shard scans its next ``w`` local tiles into its local
    heap, the merge recomputes the global heap, and queries whose global
    k_stop-th distance is at most the pmin over shards of the next local
    bound retire. The host reads the (G,) active mask once per round, as
    ``_knn_device_loop`` does. Returns (global d2, rows, [rounds,
    buckets, rows scanned, rescued], per-query retirement round, least
    refuted bounds (G, 2))."""
    coll = st.mesh.collectives
    s, l = st.shards, st.t_total
    qs = qs_f[idx]
    g = qs.shape[0]
    dev = qs.device
    lbd, lbr = lbd_f[:, idx], lbr_f[:, idx]
    order_pad = F.pad(order_f[:, idx][..., w1:], (0, budget * w - (l - w1)))
    lb_pad = F.pad(lb_f[:, idx][..., w1:], (0, budget * w + 1 - (l - w1)),
                   value=_INF)
    mt = None if mt_f is None else mt_f[:, idx]
    qs_rep = qs.repeat(s, 1)
    gbd, gbr = _shard_heap_merge(coll, lbd, lbr, k)
    active = active0.clone()
    rr = torch.zeros(g, dtype=torch.int64, device=dev)
    nbuck = torch.zeros((), dtype=torch.int64, device=dev)
    nrows = torch.zeros((), dtype=torch.int64, device=dev)
    nresc = torch.zeros((), dtype=torch.int64, device=dev)
    refuted = torch.full((g, 2), _INF, device=dev)
    r = 0
    while r < budget and bool(active.any()):
        start = r * w
        sel = order_pad[..., start:start + w]
        lb_col = lb_pad[..., start:start + w]
        colv = ~torch.isinf(lb_col)
        lbd, lbr, nv, resc, rlb = _sharded_local_scan(
            st, lay, qs_rep, sel, colv, active, lbd, lbr, mt, k, k_stop,
            lb_col=lb_col, precision=precision,
            kth0=gbd[:, k_stop - 1] if precision != "fp32" else None)
        gbd2, gbr2 = _shard_heap_merge(coll, lbd, lbr, k)
        kth = torch.sqrt(gbd2[:, k_stop - 1])
        nxt = coll.pmin(lb_pad[..., start + w])
        active2 = active & ~(kth <= nxt)
        rr = torch.where(active & ~active2, r + 1, rr)
        nbuck = nbuck + coll.psum((colv & active[None, :, None]).sum((1, 2)))
        nrows = nrows + coll.psum(nv.sum(1))
        nresc = nresc + coll.psum(resc.sum(1))
        refuted = torch.minimum(refuted, coll.pmin(rlb))
        gbd, gbr, active = gbd2, gbr2, active2
        r += 1
    rr = torch.where(active, r, rr)
    return gbd, gbr, (r, int(nbuck), int(nrows), int(nresc)), rr, refuted


def batched_knn_sharded(st: ShardedTiles, geom: LeafGeometry, data_tiles,
                        qs, k: int, *,
                        masks: Optional[torch.Tensor] = None, beam: int = 8,
                        w1: Optional[int] = None, ws: Optional[int] = None,
                        k_stop: Optional[int] = None,
                        planes: Optional[quant.TilePlanes] = None,
                        precision: str = "fp32",
                        stats: Optional[EngineStats] = None,
                        conv_out: Optional[list] = None,
                        next_lb_out: Optional[list] = None,
                        refuted_out: Optional[list] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact batched (optionally row-masked) KNN over the layout
    (``geom``, ``data_tiles``, ``planes``) placed T-sharded by ``st``: the
    contract of ``batched_knn_device``, run per shard.

    One start (mask relayout, each shard's prologue, the first round, the
    merge), one (G,) active-mask read, then the compacted straggler loop
    (``_sharded_loop``). Round widths are PER-SHARD tile counts: by
    default ``w1 = ceil(max(1, beam/2)/S)`` and ``w = ceil(beam/S)``, so
    the global first-round coverage S*w1 matches the single-device
    default; both are capped to ``_round_tiles`` of the S*G rows a round
    scans. ``conv_out`` receives per-query converged widths in per-shard
    tiles, ``next_lb_out`` the least bound over shards among tiles that
    may hold rows the scan left out, ``refuted_out`` the least refuted
    bounds (G, 2), as ``batched_knn_device`` gives them."""
    t0 = time.time()
    k_stop = k if k_stop is None else k_stop
    dev = st.mesh.device
    qs = qs.float().to(dev)
    s, l = st.shards, st.t_total
    g = int(qs.shape[0])
    if precision == "fp32":
        planes = None
    lay = (geom.bucket_rows, data_tiles, planes)
    w1 = max(1, min(w1 if w1 else max(1, -(-max(1, beam // 2) // s)), l,
                    _round_tiles(s * g, data_tiles, planes)))
    (order, lb_sorted, mt, lbd, lbr, d2, rows, active, nvalid, resc,
     refuted) = _sharded_start(st, geom, lay, qs, masks, w1=w1, k=k,
                               k_stop=k_stop, precision=precision)
    if stats is not None:
        stats.knn_rounds += 1
        stats.knn_buckets += g * w1 * s
        stats.rows_scanned += int(nvalid)
        if precision != "fp32":
            stats.mp_scanned += int(nvalid)
            stats.mp_rescued += int(resc)
    conv = np.full(g, w1, np.int64)
    act = np.nonzero(active.cpu().numpy())[0]
    d2f = d2.cpu().numpy()
    rowsf = rows.cpu().numpy()
    refuted_f = refuted.cpu().numpy()
    if len(act) and w1 < l:
        na = len(act)
        gp = _next_pow2(na)
        padded = np.zeros(gp, np.int64)
        padded[:na] = act
        idx = torch.as_tensor(padded, device=dev)
        active0 = torch.as_tensor(np.arange(gp) < na, device=dev)
        w = max(1, min(ws if ws else max(1, -(-beam // s)),
                       _round_tiles(s * gp, data_tiles, planes)))
        budget = -(-(l - w1) // w)
        bd, br, (rounds, nbuck, nrows, nresc), retire_round, rlb = \
            _sharded_loop(st, lay, idx, active0, qs, lbd, lbr, order,
                          lb_sorted, mt, w1=w1, w=w, budget=budget, k=k, k_stop=k_stop,
                          precision=precision)
        refuted_f = refuted_f.copy()
        refuted_f[act] = np.minimum(refuted_f[act], rlb[:na].cpu().numpy())
        d2f = d2f.copy()
        rowsf = rowsf.copy()
        d2f[act] = bd[:na].cpu().numpy()
        rowsf[act] = br[:na].cpu().numpy()
        conv[act] = np.minimum(
            w1 + retire_round[:na].cpu().numpy().astype(np.int64) * w, l)
        if stats is not None:
            stats.knn_rounds += rounds
            stats.knn_buckets += nbuck
            stats.rows_scanned += nrows
            if precision != "fp32":
                stats.mp_scanned += nrows
                stats.mp_rescued += nresc
    if stats is not None:
        stats.time_s += time.time() - t0
    if conv_out is not None:
        conv_out.append(conv)
    if next_lb_out is not None:
        # per shard, as batched_knn_device_async: the least bound among its
        # tiles past the converged width or at or above the final k-th
        # expansion distance (the lb2 early-out's skips); then the least
        # over shards
        lbs = F.pad(lb_sorted, (0, 1), value=_INF).double().reshape(
            s * g, l + 1)
        thr = np.sqrt(d2f[:, -1].astype(np.float64) * (1 - 4 * _U32))
        pos = torch.minimum(
            torch.searchsorted(lbs, torch.as_tensor(
                np.tile(thr, s), device=dev)[:, None]),
            torch.as_tensor(np.tile(conv, s), device=dev)[:, None])
        next_lb_out.append(st.mesh.collectives.pmin(
            torch.gather(lbs, 1, pos).view(s, g)).cpu().numpy())
    if refuted_out is not None:
        refuted_out.append(refuted_f)
    return np.sqrt(d2f), rowsf.astype(np.int64)


# ---------------------------------------------------------------------------
# Grouped predicate masks (one call per (type, attr) group)
# ---------------------------------------------------------------------------
def _ne_group_masks(col, num_lo, num_hi, row_leaf, v, tol):
    leaf_ok = ((num_lo[None, :] <= (v + tol)[:, None])
               & (num_hi[None, :] >= (v - tol)[:, None]))
    m = torch.abs(col[None, :] - v[:, None]) <= tol[:, None]
    return m & leaf_ok[:, row_leaf], int(leaf_ok.sum())


def _nr_group_masks(col, num_lo, num_hi, row_leaf, lo, hi):
    leaf_ok = ((num_lo[None, :] <= hi[:, None])
               & (num_hi[None, :] >= lo[:, None]))
    m = (col[None, :] >= lo[:, None]) & (col[None, :] <= hi[:, None])
    return m & leaf_ok[:, row_leaf], int(leaf_ok.sum())


_VR_DENSE_CUTOFF = 0.5  # surviving-tile row fraction above which the
#                         gather costs more than one dense column pass


def _vr_leaf_plan(qs, r, centroid, radius):
    """Tile-level V.R planner: (g, T) survival from the triangle bound
    |q - C| - R <= r, with the reference's conservative slack (absolute
    plus a relative ``1e-4 * dc`` term: the expansion's error grows with
    coordinate magnitude, and a wrongly pruned tile cannot be rescued)."""
    d2c = ops.pairwise_sq_l2(qs, centroid)
    dc = torch.sqrt(torch.clamp_min(d2c, 0.0))
    slack = 1e-4 * (1.0 + r[:, None] + radius[None, :]) + 1e-4 * dc
    return dc - radius[None, :] <= r[:, None] + slack


def _vr_union_eval(qs, r2, sel_u, member, data_tiles, tile_pp, bucket_rows):
    """Exact radius test over the UNION of the group's surviving tiles:
    ONE (g, d) x (d, U*cap) fp32 GEMM. Returns one packed int8
    (g, U*cap) — bit 0: within radius, bit 1: within fp noise of the
    boundary (the host re-checks those exactly)."""
    pts = data_tiles[sel_u]                          # (U, cap, d)
    rows = bucket_rows[sel_u]                        # (U, cap)
    u, cap, dim = pts.shape
    pts = pts.reshape(u * cap, dim)
    rows = rows.reshape(u * cap)
    valid = (rows >= 0)[None, :] & member.repeat_interleave(cap, dim=1)
    qq = torch.sum(qs * qs, dim=1)
    pp = tile_pp[sel_u].reshape(u * cap)
    ops.require_ieee_matmul(qs)
    cross = qs @ pts.T                               # (g, U*cap)
    d2 = torch.clamp_min(qq[:, None] + pp[None, :] - 2.0 * cross, 0.0)
    within = valid & (d2 <= r2[:, None])
    near = valid & (torch.abs(d2 - r2[:, None]) <= 1e-3 * (r2[:, None] + 1.0))
    return within.to(torch.int8) | (near.to(torch.int8) << 1)


def _vr_dense_masks(qs, r, leaf_ok, col, row_leaf):
    """Dense path: full-column distances, masked by the tile survival
    matrix through the row->tile map; rows within fp noise of the
    boundary are flagged for the host's exact re-check."""
    d2 = ops.pairwise_sq_l2(qs, col)
    r2 = (r * r)[:, None]
    m = d2 <= r2
    near = torch.abs(d2 - r2) <= 1e-3 * (r2 + 1.0)
    return m & leaf_ok[:, row_leaf], near


# ---------------------------------------------------------------------------
# Query planning
# ---------------------------------------------------------------------------
def _contains_vk(q: Q.Query) -> bool:
    return any(isinstance(b, Q.VK) for b in Q.basic_queries(q))


def plannable(q: Q.Query) -> bool:
    """True when every V.K candidate mask derives from predicate-only
    subtrees."""
    if isinstance(q, (Q.NE, Q.NR, Q.VR, Q.VK)):
        return True
    if isinstance(q, Q.And):
        return all(isinstance(p, Q.VK) or
                   (not _contains_vk(p) and plannable(p))
                   for p in q.parts)
    if isinstance(q, Q.Or):
        return all(plannable(p) for p in q.parts)
    return False


def knn_archetype(attr: str, kmax: int, masked: bool,
                  device_loop: bool, shards: int = 0) -> str:
    """QBS convergence key for one KNN job group (widths are in tiles of
    the layout the loop scans, hence the loop tag; the sharded loop's are
    per-shard tile counts, so each shard count keys apart: ``:sN``)."""
    tag = "dl" if device_loop else "hl"
    if shards:
        tag += f":s{shards}"
    return (f"VK:{attr}:k{kmax}:{'masked' if masked else 'plain'}"
            f":{tag}")


@dataclass(frozen=True)
class KnnGroupSpec:
    """One KNN job group: which jobs run together through the beam loop."""
    attr: str
    jobs: Tuple[int, ...]   # job indices, masked jobs first
    kmax: int
    n_masked: int
    archetype: str          # ``knn_archetype`` key for QBS feedback


def group_job_specs(job_specs: Sequence[Tuple[str, int, bool]],
                    device_loop: bool, shards: int = 0
                    ) -> Tuple[KnnGroupSpec, ...]:
    """The grouping policy, shared by the engine and the planner: the
    device loop runs ONE group per attribute (unmasked jobs get an
    all-true mask); the host loop keeps masked jobs apart. Within a
    group, masked jobs order first."""
    by_grp: Dict[Tuple, List[int]] = defaultdict(list)
    for i, (attr, k, masked) in enumerate(job_specs):
        key = attr if device_loop else (attr, masked)
        by_grp[key].append(i)
    specs: List[KnnGroupSpec] = []
    for key, idxs in by_grp.items():
        attr = key if device_loop else key[0]
        idxs = sorted(idxs, key=lambda i: not job_specs[i][2])
        kmax = max(job_specs[i][1] for i in idxs)
        n_masked = sum(1 for i in idxs if job_specs[i][2])
        specs.append(KnnGroupSpec(
            attr=attr, jobs=tuple(idxs), kmax=kmax, n_masked=n_masked,
            archetype=knn_archetype(attr, kmax, n_masked > 0,
                                    device_loop, shards)))
    return tuple(specs)


@dataclass
class EnginePlan:
    """Pre-derived execution structure for one batch archetype (built and
    cached by the planner): the V.K job layout, the KNN grouping and the
    QBS-seeded beam widths."""
    device_loop: bool
    job_specs: Tuple[Tuple[str, int, bool], ...]  # (attr, k, masked)/job
    groups: Tuple[KnnGroupSpec, ...]
    seeds: Optional[Dict[str, int]] = None        # archetype -> width
    shards: int = 0   # the shard count the grouping was keyed for (0:
    #                   one device); must match the executing engine
    precision: str = "fp32"   # scan precision the plan was keyed for;
    #                           must match the executing engine


def _plane_np(x: torch.Tensor) -> np.ndarray:
    """A host plane as numpy (bf16 as its 16-bit patterns)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
        return x.numpy().view(np.uint16)
    return x.numpy()


def _plane_tensor(a: np.ndarray, precision: str) -> torch.Tensor:
    """A numpy plane as a CPU tensor sharing its memory: a bf16 plane's
    data from its 16-bit patterns (uint16, or the reference's 2-byte
    bfloat16 dtype)."""
    a = np.ascontiguousarray(a)
    if precision == "bf16" and a.dtype.itemsize == 2 and a.dtype.kind != "i":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class HybridEngine:
    """Batched executor over one prepared table, on one device.
    ``HybridEngine(tree, table, meta, device=...)`` over numpy state
    (``ClusterTree``, the permuted ``MMOTable``, ``LeafMeta``).
    ``precision`` selects the KNN scan ("fp32", "bf16" or "int8"; rows
    are the same). ``quant_cache`` (a persisted snapshot: the
    ``snapshot_planes`` dict plus a ``precision`` entry) supplies the base
    layouts' planes instead of quantizing them (``_make_planes``).
    ``cost_model`` (a
    ``cost.CostModel`` or None) steers the V.R dense-vs-tile route once
    both V.R kinds are reliably fitted (``_vr_masks``); the owning
    platform refreshes it on every ``engine()`` call, and unions its
    un-folded appends in through ``sync_delta``.

    ``shards``: None keeps the single-device paths; S >= 1 also places
    both layouts' tiles over a ``TileMesh`` of S shards (``mesh``, default
    ``tile_mesh(S, device)``), and the device loop and the V.R tile route
    run sharded (S = 1 runs the whole sharded program on one shard),
    reading the same arrays as the single-device paths through that
    placement. The host loop, the dense V.R pass and the re-rank's
    widening run as on one device."""

    def __init__(self, tree, table, meta, *, beam: int = 16,
                 tile: int = 128, device_loop: bool = True,
                 device_tile: Optional[int] = None, device=None,
                 precision: str = "fp32", quant_cache=None,
                 cost_model=None, shards: Optional[int] = None,
                 mesh: Optional[TileMesh] = None):
        if precision not in quant.PRECISIONS:
            raise ValueError(f"precision must be one of {quant.PRECISIONS},"
                             f" got {precision!r}")
        self.cost_model = cost_model
        # mixed-precision tile scan: both beam-loop layouts get planes
        # built here; the V.R predicate path stays fp32
        self.precision = precision
        self.vec_planes: Dict[str, quant.TilePlanes] = {}
        self.vec_planes_dev: Dict[str, quant.TilePlanes] = {}
        # the base layouts' planes on the host, (layout, attr) -> numpy
        # ``TilePlanes`` (``snapshot_planes``)
        self._planes_np: Dict[Tuple[str, str], quant.TilePlanes] = {}
        self._quant_cache = quant_cache
        self.device = dev = resolve_device(device)
        self.device_loop = device_loop
        self.device_tile = device_tile or max(32, tile // 2)
        leaves = tree.leaf_ids
        starts = np.asarray(tree.bucket_start[leaves])
        ends = np.asarray(tree.bucket_end[leaves])
        rows_np, cap, leaf_of_tile = bucket_tiles(starts, ends, tile)
        self.bucket_rows = torch.as_tensor(rows_np, dtype=torch.int64,
                                           device=dev)
        self.bucket_rows_np = rows_np
        self.cap = cap
        self.tile = tile
        self.n = table.n_rows
        self.n_leaves = len(leaves)
        self.n_tiles = len(leaf_of_tile)
        self.beam = beam
        # all metadata lives at TILE granularity; row_tile maps rows back
        row_tile = np.zeros(max(1, self.n), np.int64)
        for t in range(len(rows_np)):
            valid = rows_np[t][rows_np[t] >= 0]
            row_tile[valid] = t
        self.row_leaf = torch.as_tensor(row_tile[:self.n], device=dev)
        self.vec = {a: torch.as_tensor(np.asarray(c, np.float32), device=dev)
                    for a, c in table.vector.items()}
        self.vec_np = {a: np.asarray(c, np.float32)
                       for a, c in table.vector.items()}
        self.vec_tiles, self.vec_tile_pp = {}, {}
        self.vec_max2 = {}   # max |row|^2, padded against its fp32 rounding
        for a, c in table.vector.items():
            tiles = tile_data(c, rows_np)
            pp = (tiles ** 2).sum(-1)
            self.vec_tiles[a] = torch.as_tensor(tiles, device=dev)
            self.vec_tile_pp[a] = torch.as_tensor(pp, device=dev)
            self.vec_max2[a] = float(pp.max(initial=0)) * (
                1 + (tiles.shape[-1] + 2) * _U32)
            if precision != "fp32":
                self.vec_planes[a] = self._make_planes("host", a, tiles,
                                                       rows_np >= 0)
            del tiles, pp
        self.num = {a: torch.as_tensor(np.asarray(c, np.float32), device=dev)
                    for a, c in table.numeric.items()}
        # per-TILE balls/boxes, not the leaf's (tighter lower bounds)
        valid = rows_np >= 0
        self.geom = {a: _tile_geometry(c, rows_np, self.bucket_rows, cap)
                     for a, c in table.vector.items()}
        # finer KNN-only layout for the device beam loop
        rows_dev, cap_dev, _ = bucket_tiles(starts, ends, self.device_tile)
        br_dev = torch.as_tensor(rows_dev, dtype=torch.int64, device=dev)
        self.bucket_rows_dev = br_dev
        self.cap_dev = cap_dev
        self.vec_tiles_dev = {}
        for a, c in table.vector.items():
            tiles_d = tile_data(c, rows_dev)
            self.vec_tiles_dev[a] = torch.as_tensor(tiles_d, device=dev)
            if precision != "fp32":
                self.vec_planes_dev[a] = self._make_planes(
                    "dev", a, tiles_d, rows_dev >= 0)
            del tiles_d
        self.geom_dev = {a: _tile_geometry(c, rows_dev, br_dev, cap_dev)
                         for a, c in table.vector.items()}
        self.num_lo, self.num_hi = {}, {}
        for a, c in table.numeric.items():
            cv = np.asarray(c, np.float32)[np.maximum(rows_np, 0)]
            self.num_lo[a] = torch.as_tensor(
                np.where(valid, cv, np.inf).min(axis=1), dtype=torch.float32,
                device=dev)
            self.num_hi[a] = torch.as_tensor(
                np.where(valid, cv, -np.inf).max(axis=1),
                dtype=torch.float32, device=dev)
        # the base state: sync_delta switches the attributes above between
        # it and the base (+) delta union
        self._base = {k: getattr(self, k) for k in (
            "n", "n_tiles", "bucket_rows", "bucket_rows_np", "row_leaf",
            "vec", "vec_np", "vec_tiles", "vec_tile_pp", "vec_max2", "num",
            "num_lo", "num_hi", "geom", "geom_dev", "vec_tiles_dev",
            "vec_planes", "vec_planes_dev")}
        self.n_base = self.n
        self.delta_epoch = 0
        self.delta_rows = 0
        self.delta_tiles = 0
        self.delta_tiles_dev = 0      # the device loop's layout's
        self.shards: Optional[int] = None
        self.mesh: Optional[TileMesh] = None
        self.sharded_dev: Optional[ShardedTiles] = None
        self.sharded_vr: Optional[ShardedTiles] = None
        if shards is not None:
            self._shard(shards, mesh)

    def _shard(self, shards: int, mesh: Optional[TileMesh]):
        """The placement of both layouts over the mesh, their delta tiles
        included: the device loop's finer layout drives the sharded beam
        loop, the coarse one the sharded V.R route. Every attribute shares
        one tile layout, so one placement each serves them all; the scans
        read the engine's own arrays through it."""
        self.shards = shards
        self.mesh = mesh if mesh is not None else tile_mesh(shards,
                                                            self.device)
        self.sharded_dev = shard_tiles(
            self.mesh, int(self.bucket_rows_dev.shape[0]),
            self.delta_tiles_dev)
        self.sharded_vr = shard_tiles(self.mesh, self._base["n_tiles"],
                                      self.delta_tiles)

    def with_shards(self, shards: int,
                    mesh: Optional[TileMesh] = None) -> "HybridEngine":
        """A sharded engine over this engine's state: it shares the
        single-device layouts, the delta union of this engine's write
        epoch included (``sync_delta`` replaces them and never writes
        them), and builds only their placement over the mesh, so no
        layout is derived from the table again."""
        eng = copy.copy(self)
        eng._shard(shards, mesh)
        return eng

    def _make_planes(self, layout: str, attr: str, tiles_np: np.ndarray,
                     valid: np.ndarray) -> quant.TilePlanes:
        """One base tile layout's planes on the device: taken from
        ``quant_cache`` when it holds this precision's planes for
        ``{layout}__{attr}`` ("host": the host loop's layout, "dev": the
        device loop's) and their ``data`` has the tiles' shape, else
        quantized here on the host (the reference's numpy, so the planes
        are its bit for bit). The host copies stay in ``_planes_np``."""
        cache = self._quant_cache
        planes = None
        if cache and cache.get("precision") == self.precision:
            keys = [f"{layout}__{attr}__{c}" for c in quant.TilePlanes._fields]
            if all(k in cache for k in keys):
                cand = quant.TilePlanes(*(np.asarray(cache[k]) for k in keys))
                if cand.data.shape == tiles_np.shape:
                    planes = cand
        if planes is None:
            planes = quant.TilePlanes(*(
                _plane_np(x) for x in quant.plan_tiles(tiles_np, valid,
                                                       self.precision)))
        self._planes_np[(layout, attr)] = planes
        return self._upload_planes(quant.TilePlanes(*(
            _plane_tensor(x, self.precision) for x in planes)))

    def _upload_planes(self, planes: quant.TilePlanes) -> quant.TilePlanes:
        return quant.TilePlanes(*(x.to(self.device) for x in planes))

    def snapshot_planes(self) -> Dict[str, np.ndarray]:
        """The base layouts' planes as flat numpy arrays under the
        reference's keys ``{layout}__{attr}__{component}`` (what
        ``core.persist`` writes to ``quant.npz``; fed back with a
        ``precision`` entry as ``quant_cache`` they are taken as they
        are). bf16 values are given as their 16-bit patterns (uint16):
        numpy has no bfloat16."""
        out: Dict[str, np.ndarray] = {}
        for (layout, attr), planes in self._planes_np.items():
            for comp, arr in zip(planes._fields, planes):
                out[f"{layout}__{attr}__{comp}"] = arr
        return out

    # ----------------------------------------------------------- delta union
    def _delta_group_count(self, delta) -> int:
        """One grouping centre per device tile of capacity: fixed by the
        capacity, so tile budgets never depend on the data."""
        return max(1, delta.capacity // self.cap_dev)

    def _delta_groups(self, delta) -> List[np.ndarray]:
        """Cluster the live delta rows (four k-means steps over the first
        vector attribute, k = ``_delta_group_count``) and sort each group
        by distance to its centre, so delta tiles are cut within groups
        and their balls prune as tightly as base tiles'. The distances
        run on the device, the steps are the reference's host numpy. Only
        tile membership depends on it, never a result."""
        m = delta.m
        k = self._delta_group_count(delta)
        a = next(iter(delta.vector_dims), None)
        if a is None or m <= 1 or k <= 1:
            return [np.arange(m, dtype=np.int64)]
        pts_np = delta.vector[a][:m]
        pts = torch.as_tensor(pts_np, dtype=torch.float32, device=self.device)
        cen = pts_np[np.linspace(0, m - 1, k).astype(int)].copy()
        for _ in range(4):
            d2 = ops.pairwise_sq_l2(pts, torch.as_tensor(
                cen, device=self.device)).cpu().numpy()
            asg = d2.argmin(axis=1)
            sums = np.zeros_like(cen)
            np.add.at(sums, asg, pts_np)
            cnt = np.bincount(asg, minlength=k)
            nz = cnt > 0
            cen[nz] = sums[nz] / cnt[nz][:, None]
        dist = d2[np.arange(m), asg]
        groups = []
        for j in range(k):
            sel = np.nonzero(asg == j)[0]
            if len(sel):
                groups.append(sel[np.argsort(dist[sel], kind="stable")]
                              .astype(np.int64))
        return groups

    def _delta_layout(self, delta, cap: int, groups: List[np.ndarray]):
        """Delta tiles of ``cap`` rows: (global row ids (Td, cap), clipped
        local index, validity, per-row tile map). Chunks align to group
        boundaries, with one slack tile per group in the budget, so Td is
        fixed by the capacity alone."""
        td = delta.n_tiles(cap) + self._delta_group_count(delta)
        slots = np.full((td, cap), -1, np.int64)
        row_tile = np.zeros(delta.capacity, np.int64)
        t = 0
        for g in groups:
            for c0 in range(0, len(g), cap):
                chunk = g[c0:c0 + cap]
                slots[t, :len(chunk)] = chunk
                row_tile[chunk] = t
                t += 1
        assert t <= td, (t, td)
        valid = slots >= 0
        rows = np.where(valid, self.n_base + slots, -1)
        # pad rows keep tile 0: their NaN columns fail every predicate
        return rows, np.maximum(slots, 0), valid, row_tile

    @staticmethod
    def _delta_geom(pts: np.ndarray, valid: np.ndarray):
        """Exact per-tile balls over the live slots (host numpy, the
        reference's); empty tiles get radius -inf (lower bound +inf)."""
        cnt = valid.sum(1)
        cen = pts.sum(1) / np.maximum(cnt, 1)[:, None]
        d2 = ((pts - cen[:, None, :]) ** 2).sum(2)
        rad = np.where(cnt > 0,
                       np.sqrt(np.max(np.where(valid, d2, 0.0), axis=1)),
                       -np.inf)
        return (np.where(cnt[:, None] > 0, cen, 0.0).astype(np.float32),
                rad.astype(np.float32))

    def _union_geom(self, g0: LeafGeometry, cen: np.ndarray,
                    rad: np.ndarray, bucket_rows: torch.Tensor
                    ) -> LeafGeometry:
        """A base layout's balls with the delta tiles' appended; the
        re-rank's error scales cover both (empty tiles' centres are 0 and
        their radii -inf)."""
        dev = self.device
        return LeafGeometry(
            centroid=torch.cat([g0.centroid, torch.as_tensor(cen, device=dev)]),
            radius=torch.cat([g0.radius, torch.as_tensor(rad, device=dev)]),
            bucket_rows=bucket_rows, cap=g0.cap,
            cen_max2=max(g0.cen_max2, float(
                (cen.astype(np.float64) ** 2).sum(1).max(initial=0))),
            rad_max=max(g0.rad_max, float(rad.max(initial=0))))

    def sync_delta(self, delta, epoch: int):
        """Bring the device state to the platform's write epoch: nothing
        while it is unchanged, the base state when the delta is empty,
        else the base (+) delta union, uploading only the delta."""
        if epoch == self.delta_epoch:
            return
        self.delta_epoch = epoch
        live = 0 if delta is None else delta.m
        base = self._base
        if live == 0:
            for k, v in base.items():
                setattr(self, k, v)
            self.delta_rows = 0
            self.delta_tiles = self.delta_tiles_dev = 0
            if self.mesh is not None:
                self._shard(self.shards, self.mesh)
            return
        dev = self.device
        nb = self.n_base
        self.n = nb + delta.capacity      # pad rows included: NaN columns
        #                                   fail every predicate, -1 tile
        #                                   slots never reach a kernel
        self.delta_rows = live
        groups = self._delta_groups(delta)
        rows_h, local_h, valid_h, row_tile_h = self._delta_layout(
            delta, self.cap, groups)
        self.delta_tiles = len(rows_h)
        self.n_tiles = base["n_tiles"] + len(rows_h)
        self.bucket_rows_np = np.concatenate(
            [base["bucket_rows_np"], rows_h.astype(np.int32)])
        self.bucket_rows = torch.cat(
            [base["bucket_rows"], torch.as_tensor(rows_h, device=dev)])
        self.row_leaf = torch.cat(
            [base["row_leaf"],
             torch.as_tensor(base["n_tiles"] + row_tile_h, device=dev)])
        rows_d, local_d, valid_d, _ = self._delta_layout(
            delta, self.cap_dev, groups)
        self.delta_tiles_dev = len(rows_d)
        br_dev_u = torch.cat([self.bucket_rows_dev,
                              torch.as_tensor(rows_d, device=dev)])
        vec, vec_np, vt, vpp, vmax2, geom = {}, {}, {}, {}, {}, {}
        vt_dev, geom_dev, vpl, vpl_dev = {}, {}, {}, {}
        for a in delta.vector_dims:
            dcol = delta.vector[a]                       # (capn, d), NaN pads
            vec_np[a] = np.concatenate([base["vec_np"][a], dcol])
            vec[a] = torch.cat([base["vec"][a],
                                torch.as_tensor(dcol, device=dev)])
            # tile gathers clip to live data and zero the pad slots: tiles
            # stay NaN-free (pads are excluded by -1 row ids anyway)
            pts_h = np.where(valid_h[:, :, None], dcol[local_h], 0.0
                             ).astype(np.float32)
            pp_h = (pts_h ** 2).sum(-1)
            vt[a] = torch.cat([base["vec_tiles"][a],
                               torch.as_tensor(pts_h, device=dev)])
            vpp[a] = torch.cat([base["vec_tile_pp"][a],
                                torch.as_tensor(pp_h, device=dev)])
            vmax2[a] = max(base["vec_max2"][a], float(pp_h.max(initial=0))
                           * (1 + (pts_h.shape[-1] + 2) * _U32))
            cen, rad = self._delta_geom(pts_h, valid_h)
            geom[a] = self._union_geom(base["geom"][a], cen, rad,
                                       self.bucket_rows)
            pts_d = np.where(valid_d[:, :, None], dcol[local_d], 0.0
                             ).astype(np.float32)
            vt_dev[a] = torch.cat([base["vec_tiles_dev"][a],
                                   torch.as_tensor(pts_d, device=dev)])
            cen_d, rad_d = self._delta_geom(pts_d, valid_d)
            geom_dev[a] = self._union_geom(base["geom_dev"][a], cen_d, rad_d,
                                           br_dev_u)
            # delta tiles get their own quantization scales, concatenated
            # tile-major like the fp32 tiles
            if self.precision != "fp32":
                for out, key, pts, ok in (
                        (vpl, "vec_planes", pts_h, valid_h),
                        (vpl_dev, "vec_planes_dev", pts_d, valid_d)):
                    dpl = self._upload_planes(
                        quant.plan_tiles(pts, ok, self.precision))
                    out[a] = quant.TilePlanes(*(
                        torch.cat([b, x]) for b, x in zip(base[key][a], dpl)))
        if self.mesh is not None:
            # every shard sees the delta tiles after its own (live on
            # shard 0 only)
            self._shard(self.shards, self.mesh)
        self.vec, self.vec_np, self.vec_max2 = vec, vec_np, vmax2
        self.vec_tiles, self.vec_tile_pp, self.geom = vt, vpp, geom
        self.vec_tiles_dev, self.geom_dev = vt_dev, geom_dev
        if self.precision != "fp32":
            self.vec_planes, self.vec_planes_dev = vpl, vpl_dev
        num, num_lo, num_hi = {}, {}, {}
        for a in delta.numeric_keys:
            dcol = delta.numeric[a]
            num[a] = torch.cat([base["num"][a],
                                torch.as_tensor(dcol, device=dev)])
            dval = dcol[local_h]
            num_lo[a] = torch.cat([base["num_lo"][a], torch.as_tensor(
                np.where(valid_h, dval, np.inf).min(axis=1),
                dtype=torch.float32, device=dev)])
            num_hi[a] = torch.cat([base["num_hi"][a], torch.as_tensor(
                np.where(valid_h, dval, -np.inf).max(axis=1),
                dtype=torch.float32, device=dev)])
        self.num, self.num_lo, self.num_hi = num, num_lo, num_hi

    def plane_bytes(self) -> int:
        """Device bytes held by the quantized planes of both layouts."""
        return sum(x.numel() * x.element_size()
                   for planes in (*self.vec_planes.values(),
                                  *self.vec_planes_dev.values())
                   for x in planes)

    # ------------------------------------------------------------ stage 1+2
    def _predicate_masks(self, queries: Sequence[Q.Query],
                         stats: EngineStats, tile_route: bool = True
                         ) -> Dict[Q.Query, np.ndarray]:
        """Exact (n,) host row masks for every distinct basic predicate
        in the batch, computed group-wise: one compare/kernel call per
        (type, attr) group."""
        nodes: List[Q.Query] = []
        seen = set()
        for q in queries:
            for b in Q.basic_queries(q):
                if isinstance(b, Q.VK) or b in seen:
                    continue
                seen.add(b)
                nodes.append(b)
        groups: Dict[Tuple[str, str], List[Q.Query]] = defaultdict(list)
        for b in nodes:
            groups[(type(b).__name__, b.attr)].append(b)

        def vals(xs):
            return torch.as_tensor(np.asarray(xs, np.float32),
                                   device=self.device)

        masks: Dict[Q.Query, np.ndarray] = {}
        for (tname, attr), grp in groups.items():
            if tname == "NE":
                m, touched = _ne_group_masks(
                    self.num[attr], self.num_lo[attr], self.num_hi[attr],
                    self.row_leaf, vals([b.value for b in grp]),
                    vals([b.tol for b in grp]))
                m = m.cpu().numpy()
            elif tname == "NR":
                m, touched = _nr_group_masks(
                    self.num[attr], self.num_lo[attr], self.num_hi[attr],
                    self.row_leaf, vals([b.lo for b in grp]),
                    vals([b.hi for b in grp]))
                m = m.cpu().numpy()
            else:  # VR
                m, touched = self._vr_masks(attr, grp, stats, tile_route)
            stats.predicate_buckets += int(touched)
            for i, b in enumerate(grp):
                masks[b] = m[i]
        return masks

    def _vr_masks(self, attr: str, grp: List[Q.Query],
                  stats: EngineStats, tile_route: bool
                  ) -> Tuple[np.ndarray, int]:
        """(g, n) exact radius masks for one V.R group. tile_route=True
        (device path): the triangle bound keeps only plausible tiles and
        distances are evaluated on their union, unless the dense column
        pass is chosen instead: by predicted cost when ``cost_model`` is
        reliably fitted for both "vr:dense" and "vr:tile" and predicts
        both, else when the survivors cover more than
        ``_VR_DENSE_CUTOFF`` of the table. On a sharded engine the bound
        and the union pass run per shard (``_vr_plan_sharded``,
        ``_vr_union_sharded``); the dense pass stays on the single-device
        column. tile_route=False (oracle path): always the dense pass.
        Both routes return the same masks; rows near the boundary are
        re-checked on the host with the exact formula either way."""
        t_vr0 = time.time()
        vecs = np.stack([b.vec() for b in grp])
        r = np.asarray([b.radius for b in grp], np.float32)
        r2 = r.astype(np.float32) ** 2
        qs = torch.as_tensor(vecs, dtype=torch.float32, device=self.device)
        r_t = torch.as_tensor(r, device=self.device)
        sharded = tile_route and self.sharded_vr is not None
        if sharded:
            leaf_ok, cols = self._vr_plan_sharded(attr, qs, r_t)
            leaf_ok_t = torch.as_tensor(leaf_ok, device=self.device)
        else:
            leaf_ok_t = _vr_leaf_plan(qs, r_t, self.geom[attr].centroid,
                                      self.geom[attr].radius)
            leaf_ok = leaf_ok_t.cpu().numpy()
        touched = int(leaf_ok.sum())
        g = len(grp)
        stats.vr_tiles_pruned += g * self.n_tiles - touched
        union = np.nonzero(leaf_ok.any(axis=0))[0]
        dim = vecs.shape[1]
        col = self.vec_np[attr]
        feats_dense = costm.vr_features("vr:dense", g, len(union),
                                        self.cap, dim, self.n)
        feats_tile = costm.vr_features("vr:tile", g, len(union),
                                       self.cap, dim, self.n)
        use_dense = len(union) * self.cap > _VR_DENSE_CUTOFF \
            * max(1, self.n)
        cm = self.cost_model
        if tile_route and cm is not None \
                and cm.reliable("vr:dense", "vr:tile"):
            pd = cm.predict("vr:dense", feats_dense)
            pt = cm.predict("vr:tile", feats_tile)
            if pd is not None and pt is not None:
                use_dense = pd <= pt
        if not tile_route or use_dense:
            if tile_route:
                stats.vr_dense_fallbacks += 1
            m, near = _vr_dense_masks(qs, r_t, leaf_ok_t, self.vec[attr],
                                      self.row_leaf)
            m, near = m.cpu().numpy(), near.cpu().numpy()
            gis, ris = np.nonzero(near)
            if len(gis):
                exact = (((col[ris] - vecs[gis]) ** 2).sum(1) <= r2[gis])
                m[gis, ris] = exact
            stats.stage_samples.append(
                ("vr:dense", feats_dense, time.time() - t_vr0))
            return m, touched
        stats.vr_tiles_scanned += touched
        if sharded:
            m = self._vr_union_sharded(attr, cols, qs, r2, vecs)
            stats.stage_samples.append(
                ("vr:tile", feats_tile, time.time() - t_vr0))
            return m, touched
        # pad the union to a power of two (bounded shape universe, as in
        # the reference); pad columns have no members
        u = len(union)
        up = _next_pow2(u)
        sel_u = np.zeros(up, np.int64)
        sel_u[:u] = union
        member = np.zeros((g, up), bool)
        member[:, :u] = leaf_ok[:, union]
        packed = _vr_union_eval(
            qs, torch.as_tensor(r2, device=self.device),
            torch.as_tensor(sel_u, device=self.device),
            torch.as_tensor(member, device=self.device),
            self.vec_tiles[attr], self.vec_tile_pp[attr],
            self.bucket_rows).cpu().numpy()
        within, near = (packed & 1).astype(bool), (packed & 2).astype(bool)
        rows = self.bucket_rows_np[sel_u].reshape(-1)     # host-side map
        m = np.zeros((g, self.n), bool)
        gis, cis = np.nonzero(within)
        m[gis, rows[cis]] = True
        gis, cis = np.nonzero(near)
        if len(gis):
            rws = rows[cis]
            exact = (((col[rws] - vecs[gis]) ** 2).sum(1) <= r2[gis])
            m[gis, rws] = exact
        stats.stage_samples.append(
            ("vr:tile", feats_tile, time.time() - t_vr0))
        return m, touched

    def _vr_plan_sharded(self, attr: str, qs, r_t
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The triangle bound over every tile ball (one distance launch),
        read per shard through its placement: each shard's own tiles and
        the delta's (live on shard 0). Returns (the survival matrix in the
        single-device tile order, (g, n_tiles); each shard's local
        survival (g, S, L))."""
        st = self.sharded_vr
        geom = self.geom[attr]
        surv = _vr_leaf_plan(qs, r_t, geom.centroid, geom.radius)
        cols = (surv[:, st.local] & st.live[None]).cpu().numpy()
        leaf_ok = np.zeros((cols.shape[0], self.n_tiles), bool)
        leaf_ok[:, st.local_np[st.live_np]] = cols[:, st.live_np]
        return leaf_ok, cols

    def _vr_union_sharded(self, attr: str, cols: np.ndarray, qs,
                          r2: np.ndarray, vecs: np.ndarray) -> np.ndarray:
        """The exact radius test per shard over the union of its own
        surviving tiles, padded to one width u (a power of two) for every
        shard, as one GEMM over the S*u tiles; the packed verdicts decode
        on the host as the single-device route's do."""
        st = self.sharded_vr
        g = cols.shape[0]
        sel_lists = [np.nonzero(cols[:, s].any(axis=0))[0]
                     for s in range(st.shards)]
        u = max(1, _next_pow2(max(len(x) for x in sel_lists)))
        sel_u = np.zeros((st.shards, u), np.int64)
        member = np.zeros((g, st.shards, u), bool)
        for s, loc in enumerate(sel_lists):
            sel_u[s, :len(loc)] = loc
            member[:, s, :len(loc)] = cols[:, s, loc]
        flat = np.take_along_axis(st.local_np, sel_u, axis=1).reshape(-1)
        dev = self.device
        packed = _vr_union_eval(
            qs, torch.as_tensor(r2, device=dev),
            torch.as_tensor(flat, device=dev),
            torch.as_tensor(member.reshape(g, -1), device=dev),
            self.vec_tiles[attr], self.vec_tile_pp[attr],
            self.bucket_rows).cpu().numpy()
        within, near = (packed & 1).astype(bool), (packed & 2).astype(bool)
        rows = self.bucket_rows_np[flat].reshape(-1)
        m = np.zeros((g, self.n), bool)
        gis, cis = np.nonzero(within)
        m[gis, rows[cis]] = True
        gis, cis = np.nonzero(near)
        if len(gis):
            rws = rows[cis]
            col = self.vec_np[attr]
            m[gis, rws] = (((col[rws] - vecs[gis]) ** 2).sum(1) <= r2[gis])
        return m

    # --------------------------------------------------------------- stage 3
    def _walk(self, q, ambient, pred_masks, jobs, job_rows, ctr):
        """Mirror of the scalar executor over host masks. Planning pass
        (job_rows None): registers every V.K as (node, candidate mask)
        and returns None for VK-containing subtrees. Finishing pass:
        substitutes batched KNN results. Traversal order is identical in
        both passes, so ``ctr`` indexes the same job list."""
        if isinstance(q, (Q.NE, Q.NR, Q.VR)):
            m = pred_masks[q]
            return m if ambient is None else (m & ambient)
        if isinstance(q, Q.VK):
            i = ctr[0]
            ctr[0] += 1
            if job_rows is None:
                jobs.append((q, ambient))
                return None
            rows = np.asarray(job_rows[i])
            m = np.zeros(self.n, bool)
            m[rows[rows >= 0]] = True
            return m
        if isinstance(q, Q.And):
            mask = ambient
            vks = []
            for p in q.parts:
                if isinstance(p, Q.VK):
                    vks.append(p)
                    continue
                pm = self._walk(p, mask, pred_masks, jobs, job_rows, ctr)
                mask = pm if mask is None else (mask & pm)
            if not vks:
                return mask if mask is not None \
                    else np.ones(self.n, bool)
            res = None
            for p in vks:
                vm = self._walk(p, mask, pred_masks, jobs, job_rows, ctr)
                if vm is not None:
                    res = vm if res is None else (res & vm)
            return res
        if isinstance(q, Q.Or):
            out = np.zeros(self.n, bool)
            any_unknown = False
            for p in q.parts:
                pm = self._walk(p, ambient, pred_masks, jobs, job_rows, ctr)
                if pm is None:
                    any_unknown = True
                else:
                    out = out | pm
            return None if any_unknown else out
        raise TypeError(q)

    def _group_jobs(self, jobs, device_loop: bool) -> List[KnnGroupSpec]:
        specs = tuple((vk.attr, vk.k, m is not None) for vk, m in jobs)
        shards = (self.shards or 0) if device_loop else 0
        return list(group_job_specs(specs, device_loop, shards))

    def _run_jobs(self, jobs, stats: EngineStats, device_loop: bool,
                  groups: Optional[Sequence[KnnGroupSpec]] = None,
                  seeds: Optional[Dict[str, int]] = None
                  ) -> List[np.ndarray]:
        """Run every V.K job as one beam-loop masked KNN per group.

        ``seeds`` maps group archetypes to QBS convergence widths. The
        device loop uses a seed as its straggler round width, the host
        loop adds it to its first doubling beam; seeds are quantized to
        powers of two and never change results. The recorded signal is
        each group's p90 width BEYOND its first round, so seeds can
        decay. ``_dispatch_jobs`` with each group finished at once."""
        return self._dispatch_jobs(jobs, stats, device_loop, groups=groups,
                                   seeds=seeds, eager=True).finish()

    def _dispatch_jobs(self, jobs, stats: EngineStats, device_loop: bool,
                       groups: Optional[Sequence[KnnGroupSpec]] = None,
                       seeds: Optional[Dict[str, int]] = None,
                       eager: bool = True, record_cost: bool = True
                       ) -> "_PendingJobs":
        """Dispatch half of ``_run_jobs``. Per group, the device loop
        uploads the queries and masks through pinned memory and enqueues
        the first round (``batched_knn_device_async``); its finisher (the
        fence, the straggler loop, the re-rank and the widening, and the
        width and cost records) runs in ``_PendingJobs.finish()``, in
        group order. The host loop and the sharded device loop run at
        dispatch, as in the reference. The single-device loop's dispatch
        takes no host sync. ``eager=True`` runs
        each finisher right after its dispatch, which is ``_run_jobs``.
        ``record_cost=False`` leaves out the KNN
        stages' wall-time samples (under overlap they would time other
        work too)."""
        pend = _PendingJobs(len(jobs))
        sharded = device_loop and self.mesh is not None
        if groups is None:
            groups = self._group_jobs(jobs, device_loop)
        # while un-folded delta tiles are unioned in, scans converge wider:
        # their widths key on the archetype with a ":delta" suffix, so the
        # base seed that post-fold batches read stays clean
        suffix = ":delta" if self.delta_tiles else ""
        for grp in groups:
            t_g0 = time.time()
            idxs = list(grp.jobs)
            attr, kmax, n_masked = grp.attr, grp.kmax, grp.n_masked
            arch = grp.archetype + suffix
            seed = seeds.get(arch) if seeds else None
            conv: list = []
            next_lb: list = []
            refuted: list = []
            qv = np.stack([jobs[i][0].vec() for i in idxs])
            qs = _to_device(qv, self.device)
            masks = None
            if n_masked:
                masks = _to_device(np.stack(
                    [jobs[i][1] for i in idxs[:n_masked]]), self.device)
                if n_masked < len(idxs):
                    masks = torch.cat(
                        [masks, torch.ones((len(idxs) - n_masked, self.n),
                                           dtype=torch.bool,
                                           device=self.device)])
            geom = self.geom_dev[attr] if device_loop else self.geom[attr]
            tiles = self.vec_tiles_dev[attr] if device_loop \
                else self.vec_tiles[attr]
            planes = None
            if self.precision != "fp32":
                planes = (self.vec_planes_dev if device_loop
                          else self.vec_planes)[attr]
            l = geom.n_leaves
            k_scan = kmax + _RERANK_EXTRA
            feat_shards, feat_tiles, feat_cap = 0, l, geom.cap
            if sharded:
                st = self.sharded_dev
                ws = max(1, _next_pow2(seed)) if seed else None
                knn = _ReadyKnn(batched_knn_sharded(
                    st, geom, tiles, qs, k_scan, masks=masks,
                    beam=self.beam, ws=ws, k_stop=kmax, planes=planes,
                    precision=self.precision, stats=stats, conv_out=conv,
                    next_lb_out=next_lb, refuted_out=refuted))
                w_base = max(1, min(-(-max(1, self.beam // 2)
                                      // st.shards), st.t_total))
                feat_shards, feat_tiles = st.shards, st.t_total
            elif device_loop:
                ws = max(self.beam, _next_pow2(seed)) if seed else None
                knn = batched_knn_device_async(
                    geom, tiles, qs, k_scan, masks=masks, beam=self.beam,
                    ws=ws, k_stop=kmax, planes=planes,
                    precision=self.precision, stats=stats, conv_out=conv,
                    next_lb_out=next_lb, refuted_out=refuted)
                w_base = max(1, min(max(1, self.beam // 2), l))
            else:
                beam_eff = max(self.beam,
                               _next_pow2(self.beam + seed)) \
                    if seed else self.beam
                knn = _ReadyKnn(batched_knn(
                    geom, tiles, qs, k_scan, masks=masks, beam=beam_eff,
                    k_stop=kmax, planes=planes, precision=self.precision,
                    stats=stats, conv_out=conv, next_lb_out=next_lb,
                    refuted_out=refuted))
                w_base = max(1, min(beam_eff, l))
            kind = costm.knn_kind(device_loop, feat_shards)
            feats = costm.knn_plan_features(
                device_loop=device_loop, shards=feat_shards, g=len(idxs),
                k=kmax, beam=self.beam, tiles=feat_tiles, cap=feat_cap,
                dim=qv.shape[1], precision=self.precision, seed=seed)

            def _fin(out, knn=knn, conv=conv, next_lb=next_lb,
                     refuted=refuted, idxs=idxs, attr=attr, arch=arch,
                     qs=qs, qv=qv, masks=masks, geom=geom, w_base=w_base,
                     kind=kind, feats=feats, t_g0=t_g0):
                dist, rows = knn.finish()
                signal = np.maximum(conv[0] - w_base, 0)
                width = int(np.ceil(np.quantile(signal, 0.9))) \
                    if len(signal) else 0
                stats.knn_group_widths.append((arch, width))
                if record_cost:
                    stats.stage_samples.append(
                        (kind, feats, time.time() - t_g0))
                fails, failed = [], []
                stats.knn_jobs += len(idxs)
                for pos, i in enumerate(idxs):
                    out[i], proven, t_k = rerank_exact(
                        self.vec_np[attr], qv[pos], dist[pos], rows[pos],
                        next_lb[0][pos], jobs[i][0].k, self.vec_max2[attr],
                        geom, refuted[0][pos])
                    if not proven:
                        fails.append((pos, jobs[i][0].k, t_k))
                        failed.append(i)
                if fails:
                    stats.knn_exact_fallbacks += len(fails)
                    for i, r in zip(failed, widen_exact(
                            self.vec_np[attr], self.vec[attr], qs, qv,
                            masks, fails, self.vec_max2[attr])):
                        out[i] = r

            if eager:
                pend.run_now(_fin)
            else:
                pend.add(_fin)
        return pend

    # -------------------------------------------------------------- explain
    def vr_tile_estimate(self, vr: Q.VR) -> Tuple[int, int]:
        """(surviving, total) tile counts under the V.R triangle bound
        for one query — the planner's pruned-tile estimate."""
        g = self.geom[vr.attr]
        ok = _vr_leaf_plan(
            torch.as_tensor(vr.vec()[None, :], device=self.device),
            torch.as_tensor([vr.radius], dtype=torch.float32,
                            device=self.device), g.centroid, g.radius)
        return int(ok.sum()), self.n_tiles

    # -------------------------------------------------------------- execute
    def _resolve_loop(self, device_loop: Optional[bool],
                      plan: Optional[EnginePlan]) -> bool:
        if plan is not None:
            # only the device loop runs sharded: host-loop plans carry
            # shards=0 and run on any engine
            want = (self.shards or 0) if plan.device_loop else 0
            if plan.shards != want:
                raise ValueError(
                    f"EnginePlan was grouped for shards={plan.shards} but "
                    f"this engine runs shards={want} (stale or mis-keyed "
                    f"plan cache)")
            if plan.precision != self.precision:
                raise ValueError(
                    f"EnginePlan was keyed for precision="
                    f"{plan.precision!r} but this engine runs "
                    f"precision={self.precision!r} "
                    f"(stale or mis-keyed plan cache)")
            return plan.device_loop
        return self.device_loop if device_loop is None else device_loop

    def _stage_batch(self, queries: Sequence[Q.Query], stats: EngineStats,
                     device_loop: bool, plan: Optional[EnginePlan]
                     ) -> Dict[Q.Query, np.ndarray]:
        """The plannability check (skipped under a planner's plan) and the
        batch's predicate masks (host numpy, so this stage syncs)."""
        if plan is None:
            for q in queries:
                if not plannable(q):
                    raise ValueError(
                        f"query not plannable for the batched engine: "
                        f"{q!r}")
        return self._predicate_masks(queries, stats, tile_route=device_loop)

    def execute_batch(self, queries: Sequence[Q.Query], *,
                      device_loop: Optional[bool] = None,
                      plan: Optional[EnginePlan] = None
                      ) -> Tuple[List[np.ndarray], EngineStats]:
        """Execute a batch of plannable query trees. Returns one row array
        per query: top-level V.K results distance-ordered, everything else
        ascending row ids. ``plan`` (from the planner) supplies the job
        layout, grouping and beam seeds; the job layout is cross-checked
        against this batch's walk."""
        device_loop = self._resolve_loop(device_loop, plan)
        t0 = time.time()
        stats = EngineStats(queries=len(queries),
                            shards=(self.shards or 0) if device_loop else 0)
        pred_masks = self._stage_batch(queries, stats, device_loop, plan)
        jobs, groups, seeds = self._plan_jobs(queries, pred_masks, plan)
        job_rows = self._run_jobs(jobs, stats, device_loop,
                                  groups=groups, seeds=seeds)
        out = self._finish_walk(queries, pred_masks, jobs, job_rows)
        stats.time_s = time.time() - t0
        return out, stats

    def execute_batch_async(self, queries: Sequence[Q.Query], *,
                            device_loop: Optional[bool] = None,
                            plan: Optional[EnginePlan] = None,
                            record_cost: bool = False) -> "PendingBatch":
        """Dispatch half of ``execute_batch``: the predicate masks (host
        numpy, as in the reference), then every KNN group's first round
        enqueued on the current stream with its results on their way to
        pinned host memory; returns without waiting. ``materialize()`` of
        the result waits on each group's event, runs the straggler loops,
        the re-rank and the finishing walk, and returns exactly
        ``execute_batch``'s (rows, stats) but for ``time_s`` (the host
        time of the two halves) and, with ``record_cost=False`` (the
        default here), the KNN stages' wall-time samples, which under
        overlap would time other batches' work too. Other batches may be
        dispatched between the two halves."""
        device_loop = self._resolve_loop(device_loop, plan)
        t0 = time.time()
        stats = EngineStats(queries=len(queries),
                            shards=(self.shards or 0) if device_loop else 0)
        pred_masks = self._stage_batch(queries, stats, device_loop, plan)
        jobs, groups, seeds = self._plan_jobs(queries, pred_masks, plan)
        pending = self._dispatch_jobs(jobs, stats, device_loop,
                                      groups=groups, seeds=seeds,
                                      eager=False, record_cost=record_cost)
        t_disp = time.time() - t0

        def _materialize():
            t1 = time.time()
            job_rows = pending.finish()
            out = self._finish_walk(queries, pred_masks, jobs, job_rows)
            stats.time_s = t_disp + (time.time() - t1)
            return out, stats

        return PendingBatch(_materialize)

    def _plan_jobs(self, queries: Sequence[Q.Query],
                   pred_masks: Dict[Q.Query, np.ndarray],
                   plan: Optional[EnginePlan]):
        """Walk the batch into V.K jobs and cross-check a cached plan's
        job layout against them. Returns (jobs, groups, seeds)."""
        jobs: List[Tuple[Q.VK, Optional[np.ndarray]]] = []
        ctr = [0]
        for q in queries:
            self._walk(q, None, pred_masks, jobs, None, ctr)
        groups = seeds = None
        if plan is not None:
            got = tuple((vk.attr, vk.k, m is not None) for vk, m in jobs)
            if got != plan.job_specs:
                raise ValueError(
                    f"EnginePlan job layout does not match this batch "
                    f"(stale or mis-keyed plan cache): plan expects "
                    f"{plan.job_specs}, walk produced {got}")
            groups, seeds = plan.groups, plan.seeds
        return jobs, groups, seeds

    def _finish_walk(self, queries: Sequence[Q.Query],
                     pred_masks: Dict[Q.Query, np.ndarray], jobs,
                     job_rows: List[np.ndarray]) -> List[np.ndarray]:
        """Finishing pass: substitute job rows into each query's mask
        walk (host numpy)."""
        out: List[np.ndarray] = []
        ctr = [0]
        for q in queries:
            if isinstance(q, Q.VK):
                ctr[0] += 1  # consume this query's own job slot
                rows = np.asarray(job_rows[ctr[0] - 1])
                out.append(rows[rows >= 0].astype(np.int64))
                continue
            m = self._walk(q, None, pred_masks, jobs, job_rows, ctr)
            out.append(np.nonzero(m)[0].astype(np.int64))
        return out
